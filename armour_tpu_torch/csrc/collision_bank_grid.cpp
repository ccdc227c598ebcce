// The launch geometry of collision_bank_grid.cuh behind a plain C interface,
// built with the host compiler (collision/kernels.py, grid_model): the CPU
// tests and bench_bank ask the model the kernels launch on, without a card.
#include "collision_bank_grid.cuh"

using namespace armour_bank;

extern "C" {

int grid_launch_path(int path, int B, int P, int L, int O, int T, int S, int jac, int a_size,
                     int o_size, int aligned, int sms) {
  return launch_path(path, B, P, L, O, T, S, jac, a_size, o_size, aligned, sms);
}
long long grid_stream_blocks(int S, int L, int O, int T, int jac, int o_size) {
  return stream_blocks(S, L, O, T, jac, o_size);
}
int grid_stream_groups(int S, int jac, int o_size) { return stream_groups(S, jac, o_size); }
int grid_block_groups(int S, int jac, int o_size) { return block_groups(S, jac, o_size); }
int grid_most_block_groups(int o_size) { return most_block_groups(o_size); }
int grid_stream_bound(int S, int jac, int o_size) { return stream_bound(S, jac, o_size); }
int grid_group_start(int k, int S, int groups, int bound, int even) {
  return group_start(k, S, groups, bound, even);
}
int grid_obstacles_per_thread(int starts, int jac, int o_size, int grouped) {
  return obstacles_per_thread(starts, jac, o_size / 4, grouped);
}
int grid_small_starts(int B, int S, int L, int O, int T, int sms) {
  return small_starts(B, S, L, O, T, sms);
}

}  // extern "C"
