// Collision bank pass: signed distance of the k-sliced link centers to every
// buffered obstacle, maximum over the 36 hyperplane pairs, and the
// argmax-select k-Jacobian.  Hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of armour_tpu/collision/pallas_kernel.py,
// which are themselves the TPU rework of the reference CUDA
// checkCollisionKernel (CollisionChecking.cu:230-299):
//   armour_collision_value_jac_multi  <- fused_collision_value_jac_multi  (pallas_kernel.py:108-186)
//                                        and, at S = 1, fused_collision_value_jac (pallas_kernel.py:30-105)
//   armour_collision_values_multi     <- fused_collision_values_multi     (pallas_kernel.py:189-237)
// Each launch takes one of two paths, a kernel template each: the streaming
// path (bank_pass) for banks that fill the card, the small-grid path
// (bank_pass_small) for banks that cannot (a batch-1 plan's, the grasp
// example's).  The launch chooses (launch_path in collision_bank_grid.cuh,
// the one model of both grids: the small-grid path where the streaming grid
// has fewer blocks than the card has SMs and the small grid runs in at most
// 3 waves) unless the caller forces a path, and reports the path it launched.
// The values-only instantiations drop the normals, the sign and the Jacobian
// epilogue.  As the Pallas kernels do, each takes any number of starts S in
// one launch.
//
// Semantics, shared with the Pallas kernels, for each (b, l, o, t) slot and
// start s:  Ac = A.c,  vp = Ac - dpos,  vn = -Ac - dneg,  v = max(vp, vn);
// a running max from -1e30 that updates on a strict '>' only, so the first
// maximum wins as jnp.argmax does; a piece with a NaN never wins.  The
// winning signed normal is -A when vp >= vn, else +A.  g = -best,
// J[i] = (signed normal) . dc[i].  A may be bf16: it is upcast and every
// sum is taken in the offsets' type.  Dead obstacle slots are masked by the
// caller (g -> -1e3, J -> 0).
//
// Layouts (all contiguous; the world axis B of the JAX vmap is explicit):
//   A (B,P,3,L,O,T)  dpos, dneg (B,P,L,O,T)  c (B,S,3,L,T)  dc (B,S,n,3,L,T)
//   g (B,S,L,O,T)    J (B,S,n,L,O,T)
//
// Bound: memory at the main path's start counts.  Per launch the kernel must
// read the bank once and write g and J once; the arithmetic is a depth-3
// product followed by a compare-and-select per (slot, start, pair), which is
// no work for the tensor cores (wgmma wants a depth of 16 and has no
// max/argmax).  At the main path's shapes (B=128, S=4, n=7, L=7, O=8,
// T=128, bf16 A, f32 offsets): 198 MB of A + 264 MB of offsets + 44 MB of
// c/dc + 118 MB of g/J = 624 MB per launch (2.94 GB at O=40).  What a
// memory-bound kernel needs is enough bytes in flight (3.35 TB/s times ~1 us
// of latency is about 25 KB for each of the 132 SMs) without paying for them
// in registers, and few enough instructions per slot that issuing them
// hides under the copies.  Values only at many starts, issuing sets the
// floor instead: at least 7 lane instructions per (slot, start, pair), so a
// 12-start plan's pool of 26 (33 M (slot, pair) items at B=128, O=8) needs
// 0.18 ms of the card's 132 SMs x 128 lanes at 1.98 GHz, the same as its
// 0.177 ms byte bound.
//
// Design of the streaming path.
// * A thread owns one (link, time step) and V obstacles of it (V = 4, 2 or
//   1): its slots are T apart on the flat (L,O,T) axis.  The centre c and its
//   k-derivative dc depend on (start, link, time) only, so the thread holds c
//   once for its V obstacles and the epilogue reads each dc element once per
//   V outputs (re-reading dc per obstacle from L2 cost 0.06 ms of 0.30 ms).
//   A block is 128 consecutive (link, obstacle group, time) items, whatever
//   T is: no thread idles at small T.
// * The bank reaches the arithmetic through shared memory.  For a fixed
//   (b, pair, component) the whole (L,O,T) slab is contiguous, and when T
//   divides 128 and V divides O a block's slots are one contiguous tile of
//   128*V slots.  A ring of kStages stages holds one hyperplane pair each
//   (three rows of A, one of dpos, one of dneg for the tile); thread 0 fills
//   a stage with five 1-D bulk copies (cp.async.bulk, the TMA unit without a
//   tensor map) that signal the stage's mbarrier; every thread waits on the
//   barrier, reads its V slots, and after a __syncthreads thread 0 refills
//   the stage with the pair kStages ahead.  The copies cost no registers, so
//   occupancy no longer limits the bytes in flight (4 stages of 7 KB per
//   block at the main shapes), and the bank slab is read from device memory
//   ONCE for all starts (the point of the _multi kernel,
//   pallas_kernel.py:109-112).  With the arithmetic taken out the kernel
//   runs no faster: the instruction stream hides under the copies.
// * Each thread keeps best[s] and, with the Jacobian, the winning signed
//   normal of its V obstacles for a group of starts in registers.  V is the
//   most of 4, 2, 1 whose state stays within 80 registers (72 where groups
//   share a block, whose threads have at most 128).  The group size
//   is a template bound: 1, 4 with the Jacobian (V = 4); 1, 4, 10 (the
//   verification pool of 2S + 2 candidates), 16 without, and 9 to 16 for
//   groups side by side (below).  The pair loop carries no `s < S` test:
//   starts past the group's last compute on c = 0 and are not stored.
// * Any S is one launch.  Up to the largest bound a block serves all starts
//   of its tile.  Above it the starts fall into groups (collision_bank_grid.cuh).
//   With the Jacobian a group holds 4 starts and is a block of its own; the G blocks
//   of one tile are neighbours in the grid (block x = tile * G + group), so
//   they run at the same time and stream the same pairs: the first block's
//   copies bring a pair from device memory into L2 and the others' copies
//   find it there.  8 starts a group would leave V = 1, whose four times as
//   many small copies cost more than a second read of the bank from L2
//   (S = 8: 0.328 ms as two groups of 4, 0.435 ms as one of 8; S = 12: 0.458
//   ms as three groups of 4, 0.703 ms as groups of 8, 0.665 ms with the
//   groups one after the other in the grid; H100 SXM, `bench_bank`).
// * Values only, a group holds up to 16 starts, and above that (a 12-start
//   plan's pool of 26) the groups sit side by side in one block
//   (GROUPS > 1): up to 4 groups of 128 threads (2 with f64 offsets), each
//   with its own c and best in registers, all reading the same ring stage, so
//   a tile's pairs come from device memory once for all its starts.  Each
//   group's template bound is exactly the largest group's size (9 to 16), so
//   at S = 26 two groups of 13 compute 26 starts, where two blocks of 16
//   computed 32 and read the bank twice.  There a block barrier per pair
//   would stall 8 warps on the slowest: a warp instead releases a stage
//   through its "empty" mbarrier once it holds its part, and warp 0 refills
//   the stage once every warp has; a pass takes the ring's 4 pairs, so each
//   pair's stage and barriers are constants.  A pair folds into best by PTX
//   max.NaN of the two pieces and fmaxf (fold: the same bits as the guard,
//   2 instructions where the guard takes 4).  The pair loop issues 214 lane
//   instructions per pair for 26 (slot, start) items, 8.2 a (slot, start,
//   pair), and warp 0 62 more for the copies (SASS, `bench_bank --sass`;
//   the 16-start body of two blocks: 305 per pair for 32 items, 9.5).  Tried
//   and slower on an H100 (`bench_bank`): a block barrier per pair, the
//   guard instead of fold, the refill by each warp in turn, 6 or 8 stages,
//   reading the next pair while one computes, 2 pairs a stage, a producer
//   warp of its own, persistent blocks (the last four at the 128-register
//   cap, or over it).  A start's arithmetic does not depend on its group, so
//   a start's g and J are the same bits at any S and in any layout.
// * The values-only body needs neither the sign nor the normals: a multiply
//   and two multiply-adds, two subtractions, the maximum of the two pieces
//   and a NaN-guarded maximum into best (fold where groups share a block).
// * Bulk copies need 16-byte alignment of every row: N * sizeof(A's type) a
//   multiple of 16 and aligned base pointers.  Shapes that miss that, a T
//   that does not divide 128 or an O that V does not divide take the direct
//   path inside the same kernel: the same ownership, scalar loads from device
//   memory that coalesce along t, any P, L, O, T.
//
// Design of the small-grid path.  At B = 1 the streaming grid is 14 blocks of
// 4 warps (7 for the grasp bank) on 132 SMs, each walking 36 pairs through
// its ring with a block barrier per pair: latency, not bytes, set its time
// (0.028 ms against a 0.0015 ms byte bound).
// * One obstacle per thread (V = 1): a block's 128 slots are one contiguous
//   run of the flat (L,O,T) axis, whatever T is.
// * Every pair of the tile in flight at once: the block's shared memory holds
//   all P pairs (36 x 128 x (3 |A| + 2 |offsets|) bytes: 64.5 KB with bf16 A
//   and f32 offsets, 184 KB in f64), filled by 16-byte cp.async copies from
//   every thread and one block barrier; nothing is refilled.  (180 bulk
//   copies of 256-512 bytes issued from one warp read 0.0126-0.0129 ms where
//   these read 0.0084-0.0092 at the batch-1 bank on an H100, `bench_bank`.)  Each
//   thread's rows of c and of the epilogue's dc are loaded while the tile
//   lands.
// * The pair axis spread over the warps: kPairGroups groups of 4 warps, group
//   k takes pairs [k * ceil(P / groups), ...) in order, keeping its best and
//   the winning pair's code.  The groups combine in shared memory in pair
//   order with the same strict '>' (or, values only, the same maximum), so
//   the first maximum wins and a NaN piece never wins, as in one sequential
//   loop; the epilogue reads the winning normal from the resident tile and
//   spreads a slot's (start, Jacobian row) outputs over its groups' threads.
//   No global scratch, no atomics.
// * As many blocks as leave one to an SM: a block takes 1, 2 or 4 starts,
//   the fewest whose grid still fits the SM count (at B = 1 and S = 4: 2
//   starts at T = 128, 112 blocks; 1 at T = 64, 112 blocks), else 4.
// * The same bits as the streaming path: both call pieces() and jac_dot(),
//   and the winner is the same pair, so g and J agree bit for bit at every
//   shape and type.  Shapes whose rows are not 16-byte aligned, or whose tile
//   does not fit a block's shared memory, stream even when the small-grid
//   path is forced (and take the direct path where its conditions say so);
//   the entry points report the path launched.
// * Its tile needs more than the default 48 KB of shared memory: the launch
//   raises the kernel's limit before its first launch on a device, as the
//   streaming path's does (allow_smem).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "collision_bank_grid.cuh"

namespace {

template <typename AT, typename OT>
__device__ __forceinline__ OT upcast(AT x) { return static_cast<OT>(x); }

template <>
__device__ __forceinline__ float upcast<__nv_bfloat16, float>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <>
__device__ __forceinline__ double upcast<__nv_bfloat16, double>(__nv_bfloat16 x) {
  return static_cast<double>(__bfloat162float(x));
}

__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }

// The values-only update of a running max by one pair's pieces: a pair with a
// NaN in either piece is skipped whole (fmax alone would drop only the NaN
// operand).  f32: max.NaN gives NaN for such a pair and fmaxf then keeps
// best, two instructions where the guard takes four, with the same result;
// f64 has no max.NaN and keeps the guard.
__device__ __forceinline__ void fold(float& best, float vp, float vn) {
  float v;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(v) : "f"(vp), "f"(vn));
  best = fmaxf(best, v);
}
__device__ __forceinline__ void fold(double& best, double vp, double vn) {
  if (vp == vp && vn == vn) best = fmax(best, fmax(vp, vn));
}

using namespace armour_bank;

template <typename OT, int MAXS, bool JAC, int GROUPS>
struct ObstaclesPerThread {
  static constexpr int value =
      obstacles_per_thread(MAXS, JAC, static_cast<int>(sizeof(OT) / 4), GROUPS > 1);
};

// ---- Hopper asynchronous copies ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival on a barrier (release: the caller's reads before it are done).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// True on one lane of the (converged) warp.
__device__ __forceinline__ bool elect_one() {
  uint32_t one;
  asm volatile(
      "{\n\t.reg .b32 lane;\n\t.reg .pred p;\n\t"
      "elect.sync lane|p, 0xffffffff;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(one));
  return one;
}

// 1-D bulk copy, device memory -> shared memory, completion on an mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 16-byte asynchronous copy, device memory -> shared memory, through L2 only.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// f(p + i, integral_constant<i>) for i = 0 .. N - 1, in order.
template <typename F, int... I>
__device__ __forceinline__ void each_stage(F& f, int p, std::integer_sequence<int, I...>) {
  (f(p + I, std::integral_constant<int, I>()), ...);
}

// ---- the arithmetic of one hyperplane pair: V obstacles, all starts --------

// The two pieces of one (pair, slot, start), and the Jacobian's dot product:
// both paths call these, so a slot's bits do not depend on the path.
template <typename OT>
__device__ __forceinline__ void pieces(OT A0, OT A1, OT A2, OT dp, OT dn, OT cx, OT cy, OT cz,
                                       OT& vp, OT& vn) {
  const OT Ac = A0 * cx + A1 * cy + A2 * cz;
  vp = Ac - dp;
  vn = -Ac - dn;
}

template <typename OT>
__device__ __forceinline__ OT jac_dot(OT a0, OT a1, OT a2, OT dx, OT dy, OT dz) {
  return a0 * dx + a1 * dy + a2 * dz;
}

template <typename OT, int MAXS, int NJ, bool JAC, int V, bool FOLD>
__device__ __forceinline__ void pair_update(
    const OT (&A0)[V], const OT (&A1)[V], const OT (&A2)[V], const OT (&dp)[V],
    const OT (&dn)[V], const OT (&cx)[MAXS], const OT (&cy)[MAXS], const OT (&cz)[MAXS],
    OT (&best)[MAXS][V], OT (&a0)[NJ][V], OT (&a1)[NJ][V], OT (&a2)[NJ][V]) {
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      OT vp, vn;
      pieces(A0[j], A1[j], A2[j], dp[j], dn[j], cx[s], cy[s], cz[s], vp, vn);
      if constexpr (JAC) {
        const bool pos = vp >= vn;
        const OT v = pos ? vp : vn;
        // strict '>': the first maximum wins; (x == x) is false for NaN
        if (vp == vp && vn == vn && v > best[s][j]) {
          best[s][j] = v;
          a0[s][j] = pos ? -A0[j] : A0[j];
          a1[s][j] = pos ? -A1[j] : A1[j];
          a2[s][j] = pos ? -A2[j] : A2[j];
        }
      } else if constexpr (FOLD) {
        fold(best[s][j], vp, vn);
      } else {
        // fmax would drop a NaN operand, which is not the rule: a pair with
        // a NaN in either piece is skipped whole
        const OT v = max_of(vp, vn);
        if (vp == vp && vn == vn) best[s][j] = max_of(best[s][j], v);
      }
    }
  }
}

template <typename AT, typename OT, int MAXS, bool JAC, int GROUPS>
__global__ void __launch_bounds__(kThreads * GROUPS) bank_pass(
    const AT* __restrict__ A, const OT* __restrict__ dpos, const OT* __restrict__ dneg,
    const OT* __restrict__ c, const OT* __restrict__ dc, OT* __restrict__ g,
    OT* __restrict__ J, int P, int L, int O, int T, int S, int n, int groups, int staged) {
  constexpr int V = ObstaclesPerThread<OT, MAXS, JAC, GROUPS>::value;
  constexpr int TILE = kThreads * V;
  constexpr int NJ = JAC ? MAXS : 1;  // no normals are kept without the Jacobian
  constexpr int ROW_A = TILE * static_cast<int>(sizeof(AT));
  constexpr int ROW_O = TILE * static_cast<int>(sizeof(OT));
  constexpr int STAGE = 3 * ROW_A + 2 * ROW_O;
  extern __shared__ __align__(128) unsigned char smem[];  // the barriers, then the ring

  // The block's tile and the start group of the thread's kThreads threads
  // (one group a block unless GROUPS > 1): starts s0 .. s0 + SG - 1.
  const int in_block = GROUPS == 1 ? 1 : blockDim.x / kThreads;
  const int blocks_per_tile = groups / in_block;
  const int k = (blockIdx.x % blocks_per_tile) * in_block + threadIdx.x / kThreads;
  const int s0 = group_start(k, S, groups, MAXS, GROUPS > 1);
  const int SG = group_start(k + 1, S, groups, MAXS, GROUPS > 1) - s0;
  // The thread's item: link l, obstacles og*V .. og*V+V-1, time step t.
  const int tid = GROUPS == 1 ? threadIdx.x : threadIdx.x % kThreads;
  const int OG = (O + V - 1) / V;  // obstacle groups of one link
  const int N = L * O * T;         // slots of one world; the launch checks that it fits an int
  const int q0 = (blockIdx.x / blocks_per_tile) * kThreads;
  const int q = q0 + tid;
  const bool live_q = q < L * OG * T;
  const int t = q % T, lg = q / T;
  const int l = lg / OG, og = lg % OG;
  const int slot0 = (l * O + og * V) * T + t;  // obstacle j of the thread: slot0 + j * T
  const int ct = l * T + t;                    // the thread's offset in the (L,T) rows of c, dc
  bool live[V];
#pragma unroll
  for (int j = 0; j < V; ++j) live[j] = live_q && og * V + j < O;
  const int64_t LT = (int64_t)L * T;
  const int64_t b = blockIdx.y;
  const int64_t bs0 = b * S + s0;    // the group's first start in the (B, S) rows of c, dc, g, J
  const AT* Aw = A + b * P * 3 * N;  // the world's bank: row r of A at Aw + r * N
  const OT* Dp = dpos + b * P * N;
  const OT* Dn = dneg + b * P * N;

  // Staged (the launch grants it when O % V == 0, 128 % T == 0 and every row
  // is 16-byte aligned): the block's 128 items are whole runs of T time
  // steps, so its slots are the contiguous tile [q0 * V, q0 * V + count).
  const uint32_t bars = smem_u32(smem);         // kStages "full" barriers
  const uint32_t empties = bars + 8 * kStages;  // GROUPS > 1: kStages "empty" barriers
  const uint32_t ring = bars + 128;
  const int tile0 = q0 * V;
  const int count = min(TILE, N - tile0);
  const uint32_t bytes_a = count * static_cast<uint32_t>(sizeof(AT));
  const uint32_t bytes_o = count * static_cast<uint32_t>(sizeof(OT));
  auto fill = [&](int p, int stage) {
    const uint32_t bar = bars + 8 * stage;
    const uint32_t dst = ring + stage * STAGE;
    const AT* Ap = Aw + (int64_t)3 * p * N + tile0;
    mbar_expect_tx(bar, 3 * bytes_a + 2 * bytes_o);
    bulk_copy(dst, Ap, bytes_a, bar);
    bulk_copy(dst + ROW_A, Ap + N, bytes_a, bar);
    bulk_copy(dst + 2 * ROW_A, Ap + 2 * (int64_t)N, bytes_a, bar);
    bulk_copy(dst + 3 * ROW_A, Dp + (int64_t)p * N + tile0, bytes_o, bar);
    bulk_copy(dst + 3 * ROW_A + ROW_O, Dn + (int64_t)p * N + tile0, bytes_o, bar);
  };
  const int warp = GROUPS > 1 ? __shfl_sync(0xffffffff, threadIdx.x / 32, 0) : 0;  // warp-uniform
  if (staged) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(bars + 8 * s, 1);
        if (GROUPS > 1) mbar_init(empties + 8 * s, blockDim.x / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int p = 0; p < kStages && p < P; ++p) fill(p, p);
  }

  OT cx[MAXS], cy[MAXS], cz[MAXS], best[MAXS][V], a0[NJ][V], a1[NJ][V], a2[NJ][V];
#pragma unroll
  for (int s = 0; s < NJ; ++s)
#pragma unroll
    for (int j = 0; j < V; ++j) a0[s][j] = a1[s][j] = a2[s][j] = static_cast<OT>(0);
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
#pragma unroll
    for (int j = 0; j < V; ++j) best[s][j] = static_cast<OT>(-1e30);
    cx[s] = cy[s] = cz[s] = static_cast<OT>(0);  // starts past the group run on c = 0, unstored
    if (s < SG && live_q) {
      const OT* cs = c + (bs0 + s) * 3 * LT + ct;
      cx[s] = cs[0];
      cy[s] = cs[LT];
      cz[s] = cs[2 * LT];
    }
  }

  OT A0[V], A1[V], A2[V], dp[V], dn[V];
  if (staged && GROUPS > 1) {
    // Groups side by side: a warp releases a stage through its "empty"
    // barrier once it holds its part, warp 0 refills the stage when every
    // warp has, and no block barrier stops the others.  A pass takes kStages
    // pairs, so that each pair's stage is a constant.
    const int rel = live_q ? slot0 - tile0 : 0;  // the thread's first slot inside the tile
    auto step = [&](int p, auto st) {
      constexpr int stage = decltype(st)::value;
      if (p >= P) return;
      const uint32_t parity = (p / kStages) & 1;
      mbar_wait(bars + 8 * stage, parity);
      const unsigned char* row = smem + 128 + stage * STAGE;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int at = rel + j * T;
        A0[j] = upcast<AT, OT>(reinterpret_cast<const AT*>(row)[at]);
        A1[j] = upcast<AT, OT>(reinterpret_cast<const AT*>(row + ROW_A)[at]);
        A2[j] = upcast<AT, OT>(reinterpret_cast<const AT*>(row + 2 * ROW_A)[at]);
        dp[j] = reinterpret_cast<const OT*>(row + 3 * ROW_A)[at];
        dn[j] = reinterpret_cast<const OT*>(row + 3 * ROW_A + ROW_O)[at];
      }
      __syncwarp();
      if (elect_one()) mbar_arrive(empties + 8 * stage);  // the warp holds its part
      if (warp == 0 && p + kStages < P) {
        mbar_wait(empties + 8 * stage, parity);  // every warp holds its part
        if (elect_one()) fill(p + kStages, stage);
        __syncwarp();
      }
      pair_update<OT, MAXS, NJ, JAC, V, true>(A0, A1, A2, dp, dn, cx, cy, cz, best, a0, a1, a2);
    };
    for (int p = 0; p < P; p += kStages)
      each_stage(step, p, std::make_integer_sequence<int, kStages>());
  } else if (staged) {
    const int rel = live_q ? slot0 - tile0 : 0;  // the thread's first slot inside the tile
    for (int p = 0; p < P; ++p) {
      const int stage = p % kStages;
      mbar_wait(bars + 8 * stage, (p / kStages) & 1);
      const unsigned char* row = smem + 128 + stage * STAGE;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int at = rel + j * T;
        A0[j] = upcast<AT, OT>(reinterpret_cast<const AT*>(row)[at]);
        A1[j] = upcast<AT, OT>(reinterpret_cast<const AT*>(row + ROW_A)[at]);
        A2[j] = upcast<AT, OT>(reinterpret_cast<const AT*>(row + 2 * ROW_A)[at]);
        dp[j] = reinterpret_cast<const OT*>(row + 3 * ROW_A)[at];
        dn[j] = reinterpret_cast<const OT*>(row + 3 * ROW_A + ROW_O)[at];
      }
      __syncthreads();  // every thread holds its part of the stage: refill it
      if (threadIdx.x == 0 && p + kStages < P) fill(p + kStages, stage);
      pair_update<OT, MAXS, NJ, JAC, V, false>(A0, A1, A2, dp, dn, cx, cy, cz, best, a0, a1, a2);
    }
  } else {
    // direct path: any P, L, O, T, scalar loads that coalesce along t
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int64_t at = slot0 + j * T;
        const bool in = live[j];
        A0[j] = in ? upcast<AT, OT>(Aw[(int64_t)(3 * p) * N + at]) : static_cast<OT>(0);
        A1[j] = in ? upcast<AT, OT>(Aw[(int64_t)(3 * p + 1) * N + at]) : static_cast<OT>(0);
        A2[j] = in ? upcast<AT, OT>(Aw[(int64_t)(3 * p + 2) * N + at]) : static_cast<OT>(0);
        dp[j] = in ? Dp[(int64_t)p * N + at] : static_cast<OT>(0);
        dn[j] = in ? Dn[(int64_t)p * N + at] : static_cast<OT>(0);
      }
      pair_update<OT, MAXS, NJ, JAC, V, (GROUPS > 1)>(A0, A1, A2, dp, dn, cx, cy, cz, best, a0, a1,
                                                      a2);
    }
  }

#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    if (s < SG) {
      const int64_t bs = bs0 + s;
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (live[j]) g[bs * N + slot0 + j * T] = -best[s][j];
      if constexpr (JAC) {
        for (int i = 0; i < n; ++i) {
          // one read of dc serves the thread's V obstacles
          const OT* d = dc + (bs * n + i) * 3 * LT + ct;
          const OT dx = live_q ? d[0] : static_cast<OT>(0);
          const OT dy = live_q ? d[LT] : static_cast<OT>(0);
          const OT dz = live_q ? d[2 * LT] : static_cast<OT>(0);
          OT* Ji = J + (bs * n + i) * N + slot0;
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (live[j]) Ji[j * T] = jac_dot(a0[s][j], a1[s][j], a2[s][j], dx, dy, dz);
        }
      }
    }
  }
}

// ---- the small-grid path: banks whose streaming grid cannot fill the card ----

template <typename AT, typename OT>
__host__ __device__ constexpr int pair_bytes() {
  return kSlots * static_cast<int>(3 * sizeof(AT) + 2 * sizeof(OT));
}

template <typename OT>
struct SmallBlocksPerSm {
  static constexpr int value = small_blocks_per_sm(static_cast<int>(sizeof(OT)));
};

template <typename AT, typename OT, int MAXS, bool JAC>
__global__ void __launch_bounds__(kSmallThreads, SmallBlocksPerSm<OT>::value) bank_pass_small(
    const AT* __restrict__ A, const OT* __restrict__ dpos, const OT* __restrict__ dneg,
    const OT* __restrict__ c, const OT* __restrict__ dc, OT* __restrict__ g,
    OT* __restrict__ J, int P, int L, int O, int T, int S, int n, int groups) {
  constexpr int ROW_A = kSlots * static_cast<int>(sizeof(AT));
  constexpr int ROW_O = kSlots * static_cast<int>(sizeof(OT));
  constexpr int PAIR = pair_bytes<AT, OT>();
  extern __shared__ __align__(128) unsigned char smem[];

  const int s0 = (blockIdx.x % groups) * MAXS;  // the block's starts s0 .. s0 + SG - 1
  const int SG = min(MAXS, S - s0);
  const int tid = threadIdx.x;
  const int i = tid % kSlots;  // the thread's slot in the tile
  const int pg = tid / kSlots;  // its pair group: warps 4 pg .. 4 pg + 3
  const int N = L * O * T;
  const int tile0 = (blockIdx.x / groups) * kSlots;
  const int count = min(kSlots, N - tile0);
  const bool live = i < count;
  const int slot = tile0 + i;  // one obstacle per thread: the flat (L,O,T) slot
  const int ct = (slot / (O * T)) * T + slot % T;
  const int64_t LT = (int64_t)L * T;
  const int64_t b = blockIdx.y;
  const int64_t bs0 = b * S + s0;
  const AT* Aw = A + b * P * 3 * N;
  const OT* Dp = dpos + b * P * N;
  const OT* Dn = dneg + b * P * N;
  const uint32_t tile_u32 = smem_u32(smem);
  const int per = (P + kPairGroups - 1) / kPairGroups;  // pairs of one group
  const int p_lo = min(P, pg * per), p_hi = min(P, p_lo + per);

  // The whole tile, every pair at once: each thread copies 16-byte chunks of
  // it (cp.async, issued from every warp), then one block barrier.  Chunks
  // past the tile's last slot are not copied.
  constexpr int CHUNKS_A = ROW_A / 16, CHUNKS_O = ROW_O / 16;
  constexpr int CHUNKS = 3 * CHUNKS_A + 2 * CHUNKS_O;  // of one pair
  const int valid_a = count * static_cast<int>(sizeof(AT));
  const int valid_o = count * static_cast<int>(sizeof(OT));
  const char* Ab = reinterpret_cast<const char*>(Aw + tile0);
  const char* Dpb = reinterpret_cast<const char*>(Dp + tile0);
  const char* Dnb = reinterpret_cast<const char*>(Dn + tile0);
  for (int k = tid; k < P * CHUNKS; k += kSmallThreads) {
    const int p = k / CHUNKS, q = k % CHUNKS;
    const char* src;
    int col;
    if (q < 3 * CHUNKS_A) {
      col = (q % CHUNKS_A) * 16;
      if (col >= valid_a) continue;
      src = Ab + ((int64_t)(3 * p + q / CHUNKS_A) * N) * sizeof(AT) + col;
    } else {
      const int r = (q - 3 * CHUNKS_A) / CHUNKS_O;
      col = ((q - 3 * CHUNKS_A) % CHUNKS_O) * 16;
      if (col >= valid_o) continue;
      src = (r ? Dnb : Dpb) + ((int64_t)p * N) * sizeof(OT) + col;
    }
    cp_async16(tile_u32 + p * PAIR + q * 16, src);
  }

  // The epilogue's items it = s * n + r (a start and a Jacobian row): a
  // thread takes every kPairGroups-th, BATCH at a time.  The first batch's
  // rows of dc are loaded now, while the tile lands.
  const int items = JAC ? SG * n : SG;
  constexpr int BATCH = JAC ? 8 : 1;
  OT d[BATCH][3];
  auto load_dc = [&](int base) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int it = base + u * kPairGroups;
      if (JAC && live && it < items) {
        const OT* row = dc + ((bs0 + it / n) * n + it % n) * 3 * LT + ct;
        d[u][0] = row[0];
        d[u][1] = row[LT];
        d[u][2] = row[2 * LT];
      }
    }
  };
  load_dc(pg);

  // The block's starts, then the group's pairs in order, with the same
  // arithmetic and rule as the streaming path; with the Jacobian the winner
  // is kept as a pair code: p + 1 when the + piece won (normal -A), -(p + 1)
  // for the - piece, 0 for none.
  OT cx[MAXS], cy[MAXS], cz[MAXS], best[MAXS];
  int win[MAXS];
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    best[s] = static_cast<OT>(-1e30);
    win[s] = 0;
    cx[s] = cy[s] = cz[s] = static_cast<OT>(0);
    if (s < SG && live) {
      const OT* cs = c + (bs0 + s) * 3 * LT + ct;
      cx[s] = cs[0];
      cy[s] = cs[LT];
      cz[s] = cs[2 * LT];
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const unsigned char* tile = smem;
  for (int p = p_lo; p < p_hi; ++p) {
    const unsigned char* row = tile + p * PAIR;
    const OT A0 = upcast<AT, OT>(reinterpret_cast<const AT*>(row)[i]);
    const OT A1 = upcast<AT, OT>(reinterpret_cast<const AT*>(row + ROW_A)[i]);
    const OT A2 = upcast<AT, OT>(reinterpret_cast<const AT*>(row + 2 * ROW_A)[i]);
    const OT dp = reinterpret_cast<const OT*>(row + 3 * ROW_A)[i];
    const OT dn = reinterpret_cast<const OT*>(row + 3 * ROW_A + ROW_O)[i];
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
      OT vp, vn;
      pieces(A0, A1, A2, dp, dn, cx[s], cy[s], cz[s], vp, vn);
      if constexpr (JAC) {
        const bool pos = vp >= vn;
        const OT v = pos ? vp : vn;
        if (vp == vp && vn == vn && v > best[s]) {
          best[s] = v;
          win[s] = pos ? p + 1 : -(p + 1);
        }
      } else {
        const OT v = max_of(vp, vn);
        if (vp == vp && vn == vn) best[s] = max_of(best[s], v);
      }
    }
  }

  // Combine the groups in pair order with the same strict '>' (the first
  // maximum wins; a NaN piece never won inside a group), then g and J.  The
  // (start, Jacobian row) outputs of a slot are spread over its groups' threads.
  OT* cbest = reinterpret_cast<OT*>(smem + P * PAIR);  // [group][start][slot]
  int* cwin = reinterpret_cast<int*>(cbest + kPairGroups * MAXS * kSlots);
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    cbest[(pg * MAXS + s) * kSlots + i] = best[s];
    if constexpr (JAC) cwin[(pg * MAXS + s) * kSlots + i] = win[s];
  }
  __syncthreads();
  if (!live) return;
  for (int base = pg; base < items; base += BATCH * kPairGroups) {
    if (base != pg) load_dc(base);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int it = base + u * kPairGroups;
      if (it >= items) break;
      const int s = JAC ? it / n : it;
      const int r = JAC ? it % n : 0;  // the Jacobian row
      OT top = cbest[s * kSlots + i];
      int w = JAC ? cwin[s * kSlots + i] : 0;
      for (int k = 1; k < kPairGroups; ++k) {
        const OT x = cbest[(k * MAXS + s) * kSlots + i];
        if constexpr (JAC) {
          if (x > top) {
            top = x;
            w = cwin[(k * MAXS + s) * kSlots + i];
          }
        } else {
          top = max_of(top, x);
        }
      }
      const int64_t bs = bs0 + s;
      if (r == 0) g[bs * N + slot] = -top;
      if constexpr (JAC) {
        OT a0 = static_cast<OT>(0), a1 = static_cast<OT>(0), a2 = static_cast<OT>(0);
        if (w != 0) {
          const unsigned char* row = tile + (abs(w) - 1) * PAIR;
          const OT A0 = upcast<AT, OT>(reinterpret_cast<const AT*>(row)[i]);
          const OT A1 = upcast<AT, OT>(reinterpret_cast<const AT*>(row + ROW_A)[i]);
          const OT A2 = upcast<AT, OT>(reinterpret_cast<const AT*>(row + 2 * ROW_A)[i]);
          a0 = w > 0 ? -A0 : A0;
          a1 = w > 0 ? -A1 : A1;
          a2 = w > 0 ? -A2 : A2;
        }
        J[(bs * n + r) * N + slot] = jac_dot(a0, a1, a2, d[u][0], d[u][1], d[u][2]);
      }
    }
  }
}

constexpr int kDevices = 64;  // devices whose SM count and shared-memory grants are kept

// Let a kernel take more than the default 48 KB of dynamic shared memory,
// before its first launch on a device that needs more than it was granted
// (also inside a stream capture: the call is no stream operation).
// `granted` is the calling launcher's own, one per kernel instantiation.
template <typename Kernel>
int allow_smem(Kernel kernel, int64_t bytes, int device, int64_t (&granted)[kDevices]) {
  const bool kept = device >= 0 && device < kDevices;
  if (bytes <= 48 * 1024 || (kept && granted[device] >= bytes)) return 0;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)bytes);
  if (!err && kept) granted[device] = bytes;
  return err;
}

template <typename AT, typename OT, int MAXS, bool JAC>
int launch_small(const AT* A, const OT* dpos, const OT* dneg, const OT* c, const OT* dc, OT* g,
                 OT* J, int B, int P, int L, int O, int T, int S, int n, int groups,
                 int device, cudaStream_t stream) {
  const int64_t tiles = cdiv((int64_t)L * O * T, kSlots);
  if (tiles * groups > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  auto kernel = bank_pass_small<AT, OT, MAXS, JAC>;
  const int64_t smem = small_smem(P, sizeof(AT), sizeof(OT), MAXS, JAC);
  static int64_t granted[kDevices] = {};
  const int err = allow_smem(kernel, smem, device, granted);
  if (err) return err;
  const dim3 grid((unsigned)(tiles * groups), B);
  kernel<<<grid, kSmallThreads, smem, stream>>>(A, dpos, dneg, c, dc, g, J, P, L, O, T, S, n,
                                                groups);
  return (int)cudaGetLastError();
}

// A kernel that does nothing: its time in a graph is the floor of any launch.
__global__ void empty_kernel() {}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The SM count of a device, read at its first launch.
int sm_count(int device, int* sms) {
  static int seen[kDevices] = {};
  if (device >= 0 && device < kDevices && seen[device]) {
    *sms = seen[device];
    return 0;
  }
  const int err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (!err && device >= 0 && device < kDevices) seen[device] = *sms;
  return err;
}

template <typename AT, typename OT, int MAXS, bool JAC, int GROUPS>
int launch_bound(const AT* A, const OT* dpos, const OT* dneg, const OT* c, const OT* dc, OT* g,
                 OT* J, int B, int P, int L, int O, int T, int S, int n, int device,
                 cudaStream_t stream) {
  constexpr int V = ObstaclesPerThread<OT, MAXS, JAC, GROUPS>::value;
  constexpr int TILE = kThreads * V;
  constexpr int SMEM = 128 + kStages * TILE * static_cast<int>(3 * sizeof(AT) + 2 * sizeof(OT));
  static_assert(2 * kStages * 8 <= 128 && SMEM <= kMaxSmem,
                "the barriers and the ring must fit a block's shared memory");
  const int64_t N = (int64_t)L * O * T;
  // staging: a block's items are whole (obstacle group, T) runs, and every
  // row of its tile starts and ends on a 16-byte boundary
  const bool staged = O % V == 0 && kThreads % T == 0 && (N * sizeof(AT)) % 16 == 0 &&
                      aligned(A, 16) && aligned(dpos, 16) && aligned(dneg, 16);
  auto kernel = bank_pass<AT, OT, MAXS, JAC, GROUPS>;
  static int64_t granted[kDevices] = {};
  const int err = allow_smem(kernel, SMEM, device, granted);
  if (err) return err;
  // the grid of launch_path's model (MAXS is stream_bound(S, JAC, sizeof(OT)))
  const int groups = stream_groups(S, JAC, sizeof(OT));
  const int threads = kThreads * block_groups(S, JAC, sizeof(OT));
  const int64_t blocks = stream_blocks(S, L, O, T, JAC, sizeof(OT));
  if (blocks > INT32_MAX || threads > kThreads * GROUPS) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, B);
  kernel<<<grid, threads, SMEM, stream>>>(A, dpos, dneg, c, dc, g, J, P, L, O, T, S, n, groups,
                                          staged);
  return (int)cudaGetLastError();
}

template <typename AT, typename OT, bool JAC>
int launch(const void* A, const void* dpos, const void* dneg, const void* c, const void* dc,
           void* g, void* J, int B, int P, int L, int O, int T, int S, int n, int path, int* ran,
           cudaStream_t stream) {
  if (B < 1 || P < 1 || L < 1 || O < 1 || T < 1 || S < 1 || (JAC && n < 1) ||
      (path != kStream && path != kSmallGrid && path != kAuto)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)L * O * T >= (int64_t)1 << 30 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const AT* a = static_cast<const AT*>(A);
  const OT* p = static_cast<const OT*>(dpos);
  const OT* m = static_cast<const OT*>(dneg);
  const OT* cc = static_cast<const OT*>(c);
  const OT* dd = static_cast<const OT*>(dc);
  OT* gg = static_cast<OT*>(g);
  OT* jj = static_cast<OT*>(J);
  int device = 0, sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err) err = sm_count(device, &sms);
  if (err) return err;
  const bool base_aligned = aligned(A, 16) && aligned(dpos, 16) && aligned(dneg, 16);
  const int take = launch_path(path, B, P, L, O, T, S, JAC, sizeof(AT), sizeof(OT),
                               base_aligned, sms);
  if (ran) *ran = take;
  if (take == kSmallGrid) {
    const int most = small_starts(B, S, L, O, T, sms);
    const int groups = (S + most - 1) / most;
    const int per_group = (S + groups - 1) / groups;
#define SMALL_LAUNCH(BOUND)                                                                    \
  return launch_small<AT, OT, BOUND, JAC>(a, p, m, cc, dd, gg, jj, B, P, L, O, T, S, n, groups, \
                                          device, stream)
    if (per_group <= 1) SMALL_LAUNCH(1);
    if (per_group <= 2) SMALL_LAUNCH(2);
    SMALL_LAUNCH(kSmallStarts);
#undef SMALL_LAUNCH
  }
#define BANK_LAUNCH(BOUND, GROUPS)                                                        \
  return launch_bound<AT, OT, BOUND, JAC, GROUPS>(a, p, m, cc, dd, gg, jj, B, P, L, O, T, S, n, \
                                                  device, stream)
  const int bound = stream_bound(S, JAC, sizeof(OT));
  if (bound == 1) BANK_LAUNCH(1, 1);
  if (bound == 4) BANK_LAUNCH(4, 1);
  if constexpr (!JAC) {
    if (block_groups(S, JAC, sizeof(OT)) > 1) {
      // values only above one start group: groups of exactly 9 to 16 starts
      // side by side in a block
      constexpr int G = most_block_groups(sizeof(OT));
      switch (bound) {
        case 9: BANK_LAUNCH(9, G);
        case 10: BANK_LAUNCH(10, G);
        case 11: BANK_LAUNCH(11, G);
        case 12: BANK_LAUNCH(12, G);
        case 13: BANK_LAUNCH(13, G);
        case 14: BANK_LAUNCH(14, G);
        case 15: BANK_LAUNCH(15, G);
        default: BANK_LAUNCH(16, G);
      }
    }
    if (bound == 10) BANK_LAUNCH(10, 1);
  }
  BANK_LAUNCH(JAC ? 4 : 16, 1);
#undef BANK_LAUNCH
}

// dtype codes: 0 = bfloat16, 1 = float32, 2 = float64.  A is stored in a
// type no wider than the offsets'.
template <bool JAC>
int dispatch(const void* A, int a_dtype, const void* dpos, const void* dneg, int o_dtype,
             const void* c, const void* dc, void* g, void* J, int B, int P, int L, int O,
             int T, int S, int n, int path, int* ran, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BANK_TYPES(AT, OT) \
  return launch<AT, OT, JAC>(A, dpos, dneg, c, dc, g, J, B, P, L, O, T, S, n, path, ran, st)
  if (o_dtype == 1) {
    if (a_dtype == 0) BANK_TYPES(__nv_bfloat16, float);
    if (a_dtype == 1) BANK_TYPES(float, float);
  } else if (o_dtype == 2) {
    if (a_dtype == 0) BANK_TYPES(__nv_bfloat16, double);
    if (a_dtype == 1) BANK_TYPES(float, double);
    if (a_dtype == 2) BANK_TYPES(double, double);
  }
#undef BANK_TYPES
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Value + k-Jacobian for any S >= 1 starts in one launch.  path: 0 streams
// the bank, 1 takes the small-grid path where the shape allows it (else
// streams), 2 chooses (collision_bank_grid.cuh, launch_path); *ran (when
// not null) receives the path launched, 0 or 1.
int armour_collision_value_jac_multi(const void* A, int a_dtype, const void* dpos,
                                     const void* dneg, int o_dtype, const void* c,
                                     const void* dc, void* g, void* J, int B, int P, int L,
                                     int O, int T, int S, int n, int path, int* ran,
                                     void* stream) {
  return dispatch<true>(A, a_dtype, dpos, dneg, o_dtype, c, dc, g, J, B, P, L, O, T, S, n,
                        path, ran, stream);
}

// Values only for any S >= 1 starts in one launch; path and ran as above.
int armour_collision_values_multi(const void* A, int a_dtype, const void* dpos,
                                  const void* dneg, int o_dtype, const void* c, void* g, int B,
                                  int P, int L, int O, int T, int S, int path, int* ran,
                                  void* stream) {
  return dispatch<false>(A, a_dtype, dpos, dneg, o_dtype, c, nullptr, g, nullptr, B, P, L, O,
                         T, S, 0, path, ran, stream);
}

// The empty kernel, one warp: the floor under any launch.
int armour_collision_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
