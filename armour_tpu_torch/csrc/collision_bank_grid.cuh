// Launch geometry of the bank pass (collision_bank.cu): the grid of each of
// its two paths and the choice between them.  Host code free of CUDA, so
// that the kernels and, through collision_bank_grid.cpp built with a host
// compiler, the CPU tests (tests/test_torch_bank_path.py) and bench_bank read
// the one model of the grid.
#pragma once

#include <stdint.h>

// group_start is also called by the kernels
#ifdef __CUDACC__
#define ARMOUR_BANK_HOST_DEVICE __host__ __device__
#else
#define ARMOUR_BANK_HOST_DEVICE
#endif

namespace armour_bank {

constexpr int kStream = 0;     // the launch's paths, as the C entry points number them
constexpr int kSmallGrid = 1;
constexpr int kAuto = 2;       // the launch chooses (launch_path)

// The streaming path: a block's tile is kThreads (link, obstacle group, time)
// items, with kThreads threads for each start group of the block.
constexpr int kThreads = 128;
constexpr int kStages = 4;           // pairs in flight per block
constexpr int kStateRegisters = 80;  // budget for the per-thread running state
// the same where start groups share a block (f32: 512 threads, at most 128
// registers a thread)
constexpr int kGroupedStateRegisters = 72;

// The small-grid path: a block is kSlots slots, one obstacle per thread, and
// kPairGroups groups of 4 warps that share the pair axis.
constexpr int kSlots = 128;
constexpr int kPairGroups = 4;
constexpr int kSmallThreads = kSlots * kPairGroups;
constexpr int kSmallStarts = 4;      // most starts of one small-grid block
constexpr int kSmallWaves = 3;       // most waves of a small grid that the launch chooses
constexpr int kMaxSmem = 232448;     // a block's dynamic shared memory on sm_90, opted in
static_assert(kSmallThreads <= 1024, "a block has at most 1024 threads");

constexpr int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Obstacles per thread of the streaming path: the most of 4, 2, 1 whose
// running state (c for every start, and per obstacle best plus, with the
// Jacobian, the normal) fits the register budget (kGroupedStateRegisters
// where start groups share a block).  `word` is the offsets' size in 32-bit
// words.  (8 fit at one start, but tiles of 1024 slots left too few blocks on
// an SM and ran slower; asking ptxas for 5 or 6 blocks per SM through
// __launch_bounds__ made it spill and ran slower too.)
constexpr int state_words(int starts, int v, bool jac, int word) {
  return starts * (3 + v * (jac ? 4 : 1)) * word;
}
constexpr int obstacles_per_thread(int starts, bool jac, int word, bool grouped = false) {
  const int budget = grouped ? kGroupedStateRegisters : kStateRegisters;
  return state_words(starts, 4, jac, word) <= budget   ? 4
         : state_words(starts, 2, jac, word) <= budget ? 2
                                                       : 1;
}

// The most start groups side by side in one block, each kThreads threads
// that read the same ring stages: 4 with f32 offsets (512 threads, so at most
// 128 registers a thread), 2 with f64 (the running state of 16 starts alone
// takes 128).
constexpr int most_block_groups(int o_size) { return o_size == 4 ? 4 : 2; }

// The streaming path's start groups.  With the Jacobian, groups of 4 starts,
// each a block of its own.  Values only, one group up to 16 starts; above
// that, the fewest groups of at most 16 side by side in a block, so that the
// block reads each pair of its tile once for all its starts (beyond
// most_block_groups, the fewest blocks a tile with as many groups in each).
// The blocks of one tile are neighbours in the grid (block x = tile *
// grid_groups + i).
constexpr int grid_groups(int S, bool jac, int o_size) {
  return (int)(jac ? cdiv(S, 4) : cdiv(cdiv(S, 16), most_block_groups(o_size)));
}
constexpr int block_groups(int S, bool jac, int o_size) {
  return jac ? 1 : (int)cdiv(cdiv(S, 16), grid_groups(S, jac, o_size));
}
constexpr int stream_groups(int S, bool jac, int o_size) {
  return grid_groups(S, jac, o_size) * block_groups(S, jac, o_size);
}

// The template bound on a group's starts, the instantiation a launch takes:
// 1 or 4 with the Jacobian; values only 1, 4, 10 or 16 for a single group,
// and above it exactly the largest group's size (9 to 16).
constexpr int stream_bound(int S, bool jac, int o_size) {
  if (jac) return S == 1 ? 1 : 4;
  const int groups = stream_groups(S, jac, o_size);
  if (groups > 1) return (int)cdiv(S, groups);
  return S <= 1 ? 1 : S <= 4 ? 4 : S <= 10 ? 10 : 16;
}

// Group k's first start (k <= groups): groups side by side split the starts
// into sizes that differ by at most one (the larger first), so that none
// computes more than one start that it does not store; otherwise each group
// takes `bound` starts in order and the last the rest.
ARMOUR_BANK_HOST_DEVICE constexpr int group_start(int k, int S, int groups, int bound, bool even) {
  return even ? k * (S / groups) + (k < S % groups ? k : S % groups)
              : (k * bound < S ? k * bound : S);
}

// Blocks of one world's streaming grid: tiles of kThreads items, times the
// blocks of a tile.
constexpr int64_t stream_blocks(int S, int L, int O, int T, bool jac, int o_size) {
  const int v = obstacles_per_thread(stream_bound(S, jac, o_size), jac, o_size / 4,
                                     block_groups(S, jac, o_size) > 1);
  return cdiv((int64_t)L * cdiv(O, v) * T, kThreads) * grid_groups(S, jac, o_size);
}

// Shared memory of a small-grid block: every pair of the tile, then each pair
// group's best (and, with the Jacobian, winner) per start.
constexpr int64_t small_smem(int P, int a_size, int o_size, int starts, bool jac) {
  return (int64_t)P * kSlots * (3 * a_size + 2 * o_size) +
         (int64_t)kPairGroups * starts * kSlots * (o_size + (jac ? 4 : 0));
}

// Small-grid blocks one SM holds: two with f32 offsets (81 KB of tile each
// at P = 36, so at most 64 registers a thread); an f64 tile takes an SM's
// shared memory.
constexpr int small_blocks_per_sm(int o_size) { return o_size == 4 ? 2 : 1; }

// Starts of one small-grid block: 1 or 2 where the grid still leaves a block
// to each SM, else kSmallStarts (the fewest blocks).
constexpr int small_starts(int B, int S, int L, int O, int T, int sms) {
  const int64_t tiles = cdiv((int64_t)L * O * T, kSlots);
  return B * tiles * S <= sms ? 1 : B * tiles * cdiv(S, 2) <= sms ? 2 : kSmallStarts;
}

// Blocks of the whole small grid.
constexpr int64_t small_blocks(int B, int S, int L, int O, int T, int sms) {
  return B * cdiv((int64_t)L * O * T, kSlots) * cdiv(S, small_starts(B, S, L, O, T, sms));
}

// The path a launch takes.  The small-grid path needs every row of the bank
// 16-byte aligned (`aligned`: the base pointers are) and its tile inside a
// block's shared memory; a launch that cannot take it streams, even when
// forced.  kAuto takes it where the streaming grid has fewer blocks than the
// card has SMs and the small grid runs in at most kSmallWaves waves: a
// streaming block that walks all pairs alone costs about 17-21 us at any
// start count, a wave of small blocks about 5.5 us (values only, 4 starts a
// block; on an H100 this choice was within 5 % of the faster path in 176 of
// 180 timed rows, B = 1 to 16, O = 8 and 16, T = 64 and 128, the other 4
// within 8 %).
constexpr int launch_path(int path, int B, int P, int L, int O, int T, int S, bool jac,
                          int a_size, int o_size, bool aligned, int sms) {
  const bool fits = aligned && ((int64_t)L * O * T * a_size) % 16 == 0 &&
                    small_smem(P, a_size, o_size, kSmallStarts, jac) <= kMaxSmem;
  if (!fits || path == kStream) return kStream;
  if (path == kSmallGrid) return kSmallGrid;
  return B * stream_blocks(S, L, O, T, jac, o_size) < sms &&
                 small_blocks(B, S, L, O, T, sms) <=
                     (int64_t)kSmallWaves * small_blocks_per_sm(o_size) * sms
             ? kSmallGrid
             : kStream;
}

}  // namespace armour_bank
