// Closed-loop plant rollout: the low-level controller and the RK4 plant of
// every world, advanced through all n_steps fixed steps in ONE launch.
// Hand-written for Hopper (sm_90a).
//
// Replaces the compiled scan of the JAX package's rollout,
// armour_tpu/sim/agent.py:236 (lax.scan of rk4_step, :212-234, under the
// episode's jax.jit, armour_tpu/sim/harness.py:82-85).  That scan has no
// Pallas kernel: XLA fuses its body.  The port's plain version is
// armour_tpu_torch/sim/agent.py::rollout_plain (one CUDA graph of ~2,650
// small kernels per step, replayed n_steps times); this kernel computes what
// its step() computes, in the same order of operations where that order sets
// the bits:
//   * the reference at t = (scalar)((double)i * dt) + t_offset, clamped to
//     [0, duration]: the Bezier of jrs/bezier.py::bezier_ref, or the ARMTD
//     peak-and-brake of jrs/armtd.py::armtd_ref (traj_orig);
//   * the controller (robust, althoff, nominal passivity, PID, iLQR;
//     control/robust.py, control/ilqr.py) on the measured state
//     q + noise[i, 0], qd + noise[i, 1], with the nominal link constants;
//   * four plant evaluations with the true parameters: M(q) from nf
//     unit-acceleration RNEA rows (no gravity, armature on the diagonal) and
//     the bias row (qdd = 0, gravity, damping), then M x = u - bias by the
//     LDL^T elimination of ops/linalg.py::spd_solve_small (pivots clamped at
//     1e-30, each multiplier a division row[j] / p);
//   * the RK4 combination with the zero-order hold of u, and i_err += dt e_pos;
//   * every log_every steps, q and qd before the step and the step's q_ref,
//     qd_ref and u: the rows the plain version's host loop keeps.
// There is no fast math and no tensor-core arithmetic: full-precision sin,
// cos, division and square root.  nvcc contracts a*b + c into FMAs, so the
// last bits differ from the plain version's; the card tests state the
// tolerances (f64 1e-9 on the end state; f32 1e-4 rad, 1e-3 rad/s).
//
// Bound: the dependency chain.  The steps are serial (step i + 1 needs the
// state of step i), and so are a step's four plant evaluations; each is a
// forward and a backward recursion over the joints and an nf-pivot
// elimination.  The arithmetic per world and step is 44,730 operations for
// the Kinova's robust move (sim/rollout_kernel.py::operation_count): at
// B = 128 a 1,000-step move is 5.7 GFLOP, 0.0855 ms of the card's f32 peak;
// the chain of dependent operations is ~1,205 per step
// (dependent_ops_per_step), 2.43 ms per move at 4 cycles each and 1.98 GHz.
// With one world per SM, what bounds a step is the latency of the longest
// serial piece of it on one warp, and of the hand-offs between the pieces.
//
// Layout: one block of eight warps per world (B <= 132 worlds put one block
// on each SM, its warps over the SM's four schedulers), the pieces of a step
// that do not depend on each other on different warps:
//   warp 0  the state: lane j owns joint j (q, qd, the RK4 stages and sums,
//           i_err, the measured state, the log rows) and computes joint j's
//           rotations ahead of use; every lane runs the solve of
//           M x = u - bias (the same instructions, so the warp stays
//           converged) and keeps its joint's x;
//   warp 1  each plant evaluation's bias row (the moving RNEA pass, lane 0);
//   warps 2, 3  the mass matrix at the even and the odd evaluations: lane c
//           runs column c (a pass at zero rates, w = wa = 0 throughout); one
//           shared-memory transpose gives lane r row r, and the rows are
//           eliminated in registers, each pivot row broadcast by
//           __shfl_sync in a branch-free loop; the multipliers, the
//           eliminated rows and the pivots go to the evaluation's slot;
//   warp 4  the controller's nominal pass, then the next step's reference;
//   warps 5-7  the controller's other passes: robust, the nominal M r pass;
//           robust and althoff, the absolute-value pass; robust, the
//           absolute M r pass.
// The evaluations are pipelined.  Evaluation k of RK4 is at position
// P_k = q + c_k V_{k-1} and rates V_k = qd + c_k KV_{k-1}, so P_{k+1} is known
// as soon as V_k is, one solve before the evaluation itself, and M depends
// on the position alone.  So warp 0 makes the rotations at P_{k+1} (and, in
// the last evaluation, the next step's position, reference point and
// controller rotations) while warp 1 runs evaluation k's bias row, and a
// mass-matrix warp forms and factorises M(P_{k+1}) meanwhile; the two
// mass-matrix warps take the evaluations in turn, each with its own slot of
// rotations and factors.  What is left on a step's critical path is, per
// evaluation, the rates, the bias row and the solve, and once a step the
// controller's passes (beside the first bias row) and the control law.
// A pass's joint loop is rolled (two joints a trip), so that each warp's
// loop is compact code: fully unrolled, a pass is 1,500-2,500 instructions
// of straight-line code, and warps streaming through several of them wait
// on instruction fetch (measured on an H100: 9,000 cycles for a moving pass,
// against 3,800 rolled).  A pass keeps its recursion state in registers and
// its per-link forces in its own slice of shared memory (Work, an object
// apart from the robot constants, so that the compiler may read the
// constants ahead of those stores).  The Kinova (7 joints, all actuated)
// has an instantiation with its joint count a template constant, so its
// passes test no axis; any other chain (at most MAXJ bodies) takes the
// instantiation with a run-time joint count and one mass-matrix warp.  The measurement noise is read a step ahead.
//
// Barriers on the state warp's path per step (robust, Kinova): the step
// barrier, the controller's hand-off, three bias rows, four factorisations,
// the next step's reference and one __syncwarp (11 waits), and three rates
// and four positions handed on (7 arrive-only, barrier.arrive); a layout
// with one warp per world and everything in shared memory needs 81
// __syncwarp per step (one per stage of each evaluation, and one per pivot
// and per back substitution of each elimination).
//
// Buffers (scalar = float or double, all contiguous, packed by
// armour_tpu_torch/sim/rollout_kernel.py::pack):
//   spec  (SPEC_LEN)         fixed rotations, trans, com, nominal mass and
//                            inertia, armature, damping, then gravity, kr,
//                            alpha, v_max, dm, dI
//   ispec (ISPEC_LEN) int32  n_joints, n_factors, axes[MAXJ], continuous[MAXJ]
//   world (B, WORLD_LEN)     q, qd, q0, qd0, qdd0, k_actual, t_offset, then the
//                            true mass and inertia
//   noise (n_steps, 2, B, nf) or null;  gains (B, n_knots, nf, 2 nf) or null
//   q_out, qd_out (B, nf);  log_* (B, S, nf), S = ceil(n_steps / log_every)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXJ = 16;        // bodies of the chain (fixed ones included): the compile-time bound

constexpr int OFF_FIXED = 0;                          // (MAXJ + 1) x 9
constexpr int OFF_TRANS = OFF_FIXED + (MAXJ + 1) * 9;  // (MAXJ + 1) x 3
constexpr int OFF_COM = OFF_TRANS + (MAXJ + 1) * 3;    // MAXJ x 3
constexpr int OFF_MASS = OFF_COM + MAXJ * 3;           // MAXJ, nominal
constexpr int OFF_INERTIA = OFF_MASS + MAXJ;           // MAXJ x 9, nominal
constexpr int OFF_ARMATURE = OFF_INERTIA + MAXJ * 9;
constexpr int OFF_DAMPING = OFF_ARMATURE + MAXJ;
constexpr int OFF_SCALARS = OFF_DAMPING + MAXJ;        // gravity, kr, alpha, v_max, dm, dI
constexpr int SPEC_LEN = OFF_SCALARS + 8;

constexpr int ISPEC_LEN = 2 + 2 * MAXJ;

constexpr int W_Q = 0, W_QD = MAXJ, W_Q0 = 2 * MAXJ, W_QD0 = 3 * MAXJ, W_QDD0 = 4 * MAXJ,
              W_K = 5 * MAXJ, W_TOFF = 6 * MAXJ, W_MASS = 7 * MAXJ, W_INERTIA = 8 * MAXJ;
constexpr int WORLD_LEN = 17 * MAXJ;

// the chains with an instantiation of their own (joint count = actuated
// joint count): the Kinova; any other takes the run-time instantiation (N = 0)
constexpr int SPECIALISED[] = {7};
constexpr int N_SPECIALISED = sizeof(SPECIALISED) / sizeof(SPECIALISED[0]);

enum { ROBUST = 0, ALTHOFF = 1, NOMINAL = 2, PID = 3, ILQR = 4 };

constexpr double PI = 3.14159265358979323846;

constexpr int THREADS = 256;    // eight warps per world
constexpr unsigned FULL = 0xffffffffu;

// The sizes an instantiation needs: NB bodies (the chain's, or MAXJ), the
// column buffer's stride CS (odd: the transpose is conflict-free), and NM
// mass-matrix warps (two take the even and the odd evaluations in turn; the
// run-time instantiation has one, to stay within 48 KB of shared memory).
template <int N>
struct Dims {
  static constexpr int NB = N > 0 ? N : MAXJ;
  static constexpr int CS = NB % 2 ? NB : NB + 1;
  static constexpr int NM = N > 0 ? 2 : 1;
};

// barriers (id, threads); the mass-matrix warps take part only in their own
constexpr int BAR_STEP = 0;     // warps 0, 1 and 4-7: the step's controller inputs (192)
constexpr int BAR_CTRL = 1;     // warps 1 and 4-7 arrive, warp 0 waits: the first bias row and
                                // the controller's passes (192)
constexpr int BAR_RATES = 2;    // warp 0 arrives, warp 1 waits: an evaluation's rates (64)
constexpr int BAR_BIAS = 3;     // warp 1 arrives, warp 0 waits: its bias row (64)
constexpr int BAR_POS = 4;      // 4 + slot: warp 0 arrives, the slot's mass-matrix warp waits:
                                // the rotations at an evaluation's position (64)
constexpr int BAR_FACT = 6;     // 6 + slot: that warp arrives, warp 0 waits: M factorised (64)
constexpr int BAR_REF = 8;      // warp 4 arrives, warp 0 waits: the next step's reference (64)

#ifdef __CUDACC__
template <int ID, int COUNT>
__device__ __forceinline__ void bar_sync() {
  asm volatile("barrier.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}
template <int ID, int COUNT>
__device__ __forceinline__ void bar_arrive() {  // the writes before it are seen by the waiters
  __threadfence_block();
  asm volatile("barrier.arrive %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}
#endif  // a host build of this source provides both, __syncwarp and __shfl_sync

// the barrier BASE + slot of an even (0) or odd (1) evaluation
template <int BASE>
__device__ __forceinline__ void bar_sync_slot(int slot) {
  if (slot == 0)
    bar_sync<BASE, 64>();
  else
    bar_sync<BASE + 1, 64>();
}
template <int BASE>
__device__ __forceinline__ void bar_arrive_slot(int slot) {
  if (slot == 0)
    bar_arrive<BASE, 64>();
  else
    bar_arrive<BASE + 1, 64>();
}

template <typename S, int N>
struct Smem {
  static constexpr int NB = Dims<N>::NB;
  S spec[SPEC_LEN];
  S world[WORLD_LEN];
  S absI[NB * 9];               // dI |nominal inertia|: the absolute passes' scaled inertia
  S Rp[2][(NB + 1) * 9];        // joint rotations at an even and an odd evaluation's position
  S Rc[(NB + 1) * 9];           // joint rotations at the controller's point
  S ve[NB];                     // joint rates at the plant's evaluation point
  S qdm[NB], cqd[NB], cqdd[NB], r[NB];  // the controller's passes' inputs
  S ref[3][NB];                 // the next step's reference q, qd, qdd
  S u[NB];
  S L[2][NB * NB], U[2][NB * NB], piv[2][NB];  // M factorised at an even and an odd evaluation
  int axes[MAXJ], cont[MAXJ];
};

// What the passes write: their torques, the columns of M and each pass
// thread's per-link forces, in a shared object of its own, so that the
// compiler may read the robot constants ahead of these stores.
template <typename S, int N>
struct Work {
  static constexpr int NB = Dims<N>::NB;
  S bias[NB], tau[NB], du[NB], mrn[NB], mrd[NB];
  S col[Dims<N>::NM][NB * Dims<N>::CS];  // a mass-matrix warp's columns: [c * CS + r] = M[r][c]
  S fn1[Dims<N>::NM][NB * 6 * NB];       // its lanes' per-link forces, lane fastest
  S fn[5][NB * 6];                        // lane 0 of warps 1 and 4-7
};

template <typename S>
__device__ __forceinline__ void cross(const S* a, const S* b, S* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// |a x b| <= abs_cross(|a|, |b|) for non-negative a, b (rnea.py::_abs_cross)
template <typename S>
__device__ __forceinline__ void abs_cross(const S* a, const S* b, S* c) {
  c[0] = a[1] * b[2] + a[2] * b[1];
  c[1] = a[2] * b[0] + a[0] * b[2];
  c[2] = a[0] * b[1] + a[1] * b[0];
}

// M v for a row-major 3 x 3 M
template <typename S>
__device__ __forceinline__ void mul(const S* M, const S* v, S* o) {
#pragma unroll
  for (int a = 0; a < 3; ++a) o[a] = M[a * 3] * v[0] + M[a * 3 + 1] * v[1] + M[a * 3 + 2] * v[2];
}

// M^T v
template <typename S>
__device__ __forceinline__ void mul_t(const S* M, const S* v, S* o) {
#pragma unroll
  for (int a = 0; a < 3; ++a) o[a] = M[a] * v[0] + M[3 + a] * v[1] + M[6 + a] * v[2];
}

// |M| v
template <typename S>
__device__ __forceinline__ void mul_abs(const S* M, const S* v, S* o) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    o[a] = fabs(M[a * 3]) * v[0] + fabs(M[a * 3 + 1]) * v[1] + fabs(M[a * 3 + 2]) * v[2];
}

template <typename S>
__device__ __forceinline__ S max_nan(S a, S b) {  // torch.maximum: NaN wins
  return (a != a || a > b) ? a : b;
}

// torch.remainder(x + pi, 2 pi) - pi: the remainder takes the divisor's sign
template <typename S>
__device__ __forceinline__ S wrap(S x) {
  const S two_pi = S(2.0 * PI);
  S a = x + S(PI);
  S m = fmod(a, two_pi);
  if (m != S(0) && ((two_pi < S(0)) != (m < S(0)))) m += two_pi;
  return m - S(PI);
}

template <typename S>
__device__ __forceinline__ S ipow(S x, int e) {  // torch's pow by a Python int
  if (e == 2) return x * x;
  if (e == 3) return x * x * x;
  return pow(x, S(e));
}

// reference (q, qd, qdd) of joint j at local time tt (offset added, not clamped)
template <typename S>
__device__ void reference(const S* w, int j, S tt, S duration, S duration2, S t_plan, double tb,
                          bool orig, S& q, S& qd, S& qdd) {
  tt = fmin(fmax(tt, S(0)), duration);
  const S q0 = w[W_Q0 + j], qd0 = w[W_QD0 + j], k = w[W_K + j];
  if (orig) {  // armtd_ref with t_total = duration
    const S qd_pk = qd0 + k * t_plan;
    const S a_br = -qd_pk / S(tb);
    const S t = fmin(fmax(tt, S(0)), duration);
    const S tau = fmax(t - t_plan, S(0));
    const S t1 = fmin(t, t_plan);
    q = q0 + qd0 * t1 + (S(0.5) * k) * (t1 * t1) + qd_pk * tau + (S(0.5) * a_br) * (tau * tau);
    const bool first = t <= t_plan;
    qd = first ? qd0 + k * t : qd_pk + a_br * tau;
    qdd = first ? k : a_br;
    return;
  }
  // bezier_ref: the degree-5 Bezier's control points and basis
  const S s = tt / duration;
  const S Tqd0 = qd0 * duration;
  const S TTqdd0 = (w[W_QDD0 + j] * duration) * duration;
  const S b0 = q0, b1 = q0 + Tqd0 / S(5.0);
  const S b2 = q0 + (S(2.0) * Tqd0) / S(5.0) + TTqdd0 / S(20.0);
  const S b3 = q0 + k;
  const S t5 = s - S(1.0);
  {
    const S B0 = -ipow(t5, 5);
    const S B1 = (S(5.0) * s) * ipow(t5, 4);
    const S B2 = (S(-10.0) * ipow(s, 2)) * ipow(t5, 3);
    const S B3 = (S(10.0) * ipow(s, 3)) * ipow(t5, 2);
    const S B4 = (S(-5.0) * ipow(s, 4)) * t5;
    const S B5 = ipow(s, 5);
    q = B0 * b0 + B1 * b1 + B2 * b2 + (B3 + B4 + B5) * b3;
  }
  {
    const S dB0 = S(-5.0) * ipow(t5, 4);
    const S dB1 = (S(20.0) * s) * ipow(t5, 3) + S(5.0) * ipow(t5, 4);
    const S dB2 = (S(-20.0) * s) * ipow(t5, 3) - (S(30.0) * ipow(s, 2)) * ipow(t5, 2);
    const S dB3 = (S(10.0) * ipow(s, 3)) * (S(2.0) * s - S(2.0)) + (S(30.0) * ipow(s, 2)) * ipow(t5, 2);
    const S dB4 = (S(-20.0) * ipow(s, 3)) * t5 - S(5.0) * ipow(s, 4);
    const S dB5 = S(5.0) * ipow(s, 4);
    qd = (dB0 * b0 + dB1 * b1 + dB2 * b2 + (dB3 + dB4 + dB5) * b3) / duration;
  }
  {
    const S ddB0 = S(-20.0) * ipow(t5, 3);
    const S ddB1 = S(40.0) * ipow(t5, 3) + (S(60.0) * s) * ipow(t5, 2);
    const S ddB2 = S(-20.0) * ipow(t5, 3) - (S(120.0) * s) * ipow(t5, 2) -
                   (S(30.0) * ipow(s, 2)) * (S(2.0) * s - S(2.0));
    const S ddB3 = S(20.0) * ipow(s, 3) + (S(60.0) * s) * ipow(t5, 2) +
                   (S(60.0) * ipow(s, 2)) * (S(2.0) * s - S(2.0));
    const S ddB4 = S(-40.0) * ipow(s, 3) - (S(60.0) * ipow(s, 2)) * t5;
    const S ddB5 = S(20.0) * ipow(s, 3);
    qdd = (ddB0 * b0 + ddB1 * b1 + ddB2 * b2 + (ddB3 + ddB4 + ddB5) * b3) / duration2;
  }
}

// the rotation of a revolute joint with fixed rotation F and signed axis at
// angle x (rnea.py::joint_rotations), into R
template <typename S>
__device__ __forceinline__ void rotation(const S* F, int axis, S x, S* R) {
  const int a = abs(axis) - 1, jj = (a + 1) % 3, kk = (a + 2) % 3;
  const S sgn = axis > 0 ? S(1) : S(-1);
  const S s = sin(x), c = cos(x);
  // J = c C + s S + K: exactly cos, +-sin, 1 or 0 (selects, so that J stays
  // in registers)
  S J[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      J[r * 3 + b] = (r == a && b == a)   ? S(1)
                     : (r == b)           ? c
                     : (r == kk && b == jj) ? sgn * s
                     : (r == jj && b == kk) ? -sgn * s
                                          : S(0);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      R[r * 3 + b] = F[r * 3] * J[b] + F[r * 3 + 1] * J[3 + b] + F[r * 3 + 2] * J[6 + b];
}

// F and N of each link between a pass's forward and backward recursion, in
// the thread's slice of Work: element (i, c) at p[(i * 6 + c) * stride]
template <typename S>
struct LinkForces {
  S* p;
  int stride;
  __device__ __forceinline__ S& operator()(int i, int c) const { return p[(i * 6 + c) * stride]; }
};

// One modified-RNEA pass at the rotations R: the forward recursion
// (rnea.py::_forward_pass) and the nominal backward pass with mass/inertia
// (_backward_pass, with armature and damping), or with ABS the
// absolute-value pass of rnea_with_bound (dm * mass, dI * |inertia|, the
// nominal constants).  A MOVING pass has the joint rates qd and qda and
// gravity; the others have w = wa = 0 throughout and no gravity, and skip
// the terms that are then exactly zero.  qdd is a shared vector or null
// (zero); unit >= 0 makes it the unit vector e_unit.  Writes the nf joint
// torques to out.
template <typename S, int N, bool MOVING, bool ABS>
__device__ void rnea(const Smem<S, N>& sm, const S* R, int n, int nf, const S* qd, const S* qda,
                     const S* qdd, int unit, const S* mass, const S* inertia, LinkForces<S> FN,
                     S* out) {
  const int nb = N > 0 ? N : n, nfb = N > 0 ? N : nf;
  const S* sp = sm.spec;
  const S dm = sp[OFF_SCALARS + 4];
  S w[3] = {0, 0, 0}, wa[3] = {0, 0, 0}, wd[3] = {0, 0, 0};
  S acc[3] = {0, 0, MOVING ? sp[OFF_SCALARS] : S(0)};
  S t1[3], t2[3], t3[3], v[3];
#pragma unroll 2
  for (int i = 0; i < nb; ++i) {
    const S* Ri = R + i * 9;
    const S* P = sp + OFF_TRANS + i * 3;
    cross(wd, P, t1);
    if (MOVING) {
      cross(wa, P, t2);
      cross(w, t2, t3);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = acc[c] + t1[c] + t3[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = acc[c] + t1[c];
    }
    mul_t(Ri, v, acc);
    if (MOVING) {
      mul_t(Ri, w, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) w[c] = v[c];
      mul_t(Ri, wa, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) wa[c] = v[c];
    }
    mul_t(Ri, wd, v);
#pragma unroll
    for (int c = 0; c < 3; ++c) wd[c] = v[c];
    // joint i has an axis iff i < nf: a RobotSpec's actuated joints come
    // first, its fixed ones last (so a specialised chain has no test here)
    if (i < nfb) {
      const int axis = sm.axes[i];
      const int a = abs(axis) - 1;
      const S sgn = axis > 0 ? S(1) : S(-1);
      const S qdd_i = unit >= 0 ? (i == unit ? S(1) : S(0)) : (qdd ? qdd[i] : S(0));
      const S zqdd_a = qdd_i * sgn;
      S zqdd[3];  // the joint-rate vectors along the signed axis
#pragma unroll
      for (int c = 0; c < 3; ++c) zqdd[c] = c == a ? zqdd_a : S(0);
      if (MOVING) {
        const S zq_a = qd[i] * sgn, zqa_a = qda[i] * sgn;
        S zq[3], zqa[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          zq[c] = c == a ? zq_a : S(0);
          zqa[c] = c == a ? zqa_a : S(0);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) w[c] = w[c] + zq[c];
        cross(wa, zq, t1);
#pragma unroll
        for (int c = 0; c < 3; ++c) wd[c] = wd[c] + t1[c] + zqdd[c];
#pragma unroll
        for (int c = 0; c < 3; ++c) wa[c] = wa[c] + zqa[c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) wd[c] = wd[c] + zqdd[c];
      }
    }
    // this joint's force and moment (the backward pass's per-link terms)
    const S* ci = sp + OFF_COM + i * 3;
    S ac[3];
    cross(wd, ci, t1);
    if (MOVING) {
      cross(wa, ci, t2);
      cross(w, t2, t3);
#pragma unroll
      for (int c = 0; c < 3; ++c) ac[c] = acc[c] + t1[c] + t3[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) ac[c] = acc[c] + t1[c];
    }
    if (!ABS) {
      const S* I = inertia + i * 9;
#pragma unroll
      for (int c = 0; c < 3; ++c) FN(i, c) = mass[i] * ac[c];
      mul(I, wd, t1);
      if (MOVING) {
        mul(I, w, t2);
        cross(wa, t2, t3);
#pragma unroll
        for (int c = 0; c < 3; ++c) FN(i, 3 + c) = t1[c] + t3[c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) FN(i, 3 + c) = t1[c];
      }
    } else {
      const S m = dm * mass[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) FN(i, c) = m * fabs(ac[c]);
      const S* aI = sm.absI + i * 9;
      const S awd[3] = {fabs(wd[0]), fabs(wd[1]), fabs(wd[2])};
      mul(aI, awd, t1);
      if (MOVING) {
        const S aw[3] = {fabs(w[0]), fabs(w[1]), fabs(w[2])};
        const S awa[3] = {fabs(wa[0]), fabs(wa[1]), fabs(wa[2])};
        mul(aI, aw, t2);
        abs_cross(awa, t2, t3);
#pragma unroll
        for (int c = 0; c < 3; ++c) FN(i, 3 + c) = t1[c] + t3[c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) FN(i, 3 + c) = t1[c];
      }
    }
  }
  // backward recursion
  S f[3] = {0, 0, 0}, nn[3] = {0, 0, 0}, Rf[3];
#pragma unroll 2
  for (int i = nb - 1; i >= 0; --i) {
    const S* Rn = R + (i + 1) * 9;
    const S Fi[3] = {FN(i, 0), FN(i, 1), FN(i, 2)};
    const S Ni[3] = {FN(i, 3), FN(i, 4), FN(i, 5)};
    const S* ci = sp + OFF_COM + i * 3;
    const S* Pn = sp + OFF_TRANS + (i + 1) * 3;
    if (!ABS) {
      mul(Rn, f, Rf);
      mul(Rn, nn, t1);
      cross(ci, Fi, t2);
      cross(Pn, Rf, t3);
    } else {
      const S aci[3] = {fabs(ci[0]), fabs(ci[1]), fabs(ci[2])};
      const S aPn[3] = {fabs(Pn[0]), fabs(Pn[1]), fabs(Pn[2])};
      mul_abs(Rn, f, Rf);
      mul_abs(Rn, nn, t1);
      abs_cross(aci, Fi, t2);
      abs_cross(aPn, Rf, t3);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) nn[c] = Ni[c] + t1[c] + t2[c] + t3[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = Rf[c] + Fi[c];
    if (i < nfb) {
      const int axis = sm.axes[i];
      const int a = abs(axis) - 1;
      const S m = a == 0 ? nn[0] : (a == 1 ? nn[1] : nn[2]);
      out[i] = ABS ? m : (axis > 0 ? m : -m);
    }
  }
  if (!ABS) {
#pragma unroll
    for (int j = 0; j < nfb; ++j) {
      const S qdd_j = unit >= 0 ? (j == unit ? S(1) : S(0)) : (qdd ? qdd[j] : S(0));
      out[j] = out[j] + sp[OFF_ARMATURE + j] * qdd_j;
      if (MOVING) out[j] = out[j] + sp[OFF_DAMPING + j] * qd[j];
    }
  }
}

// A mass-matrix warp: lane r takes row r of M from the columns col (one
// transpose through shared memory) and eliminates it in registers, pivot by
// pivot, the pivot row broadcast by shuffles; the multipliers f = row[j] / p,
// the eliminated rows and the clamped pivots go to slot s of sm.L, sm.U and
// sm.piv.  The loop is branch-free (a lane above the pivot keeps its row by
// a select), so the warp stays converged at every shuffle.
template <typename S, int N>
__device__ void factor(Smem<S, N>& sm, const S* col, int nf, int lane, int s) {
  constexpr int NX = Dims<N>::NB, CS = Dims<N>::CS;
  const bool mine = lane < nf;
  S row[NX], mult[NX], piv[NX];
#pragma unroll
  for (int c = 0; c < NX; ++c) row[c] = (mine && c < nf) ? col[c * CS + lane] : S(0);
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    if (j < nf) {
      S p = __shfl_sync(FULL, row[j], j);
      p = p < S(1e-30) ? S(1e-30) : p;
      piv[j] = p;
      const bool below = lane > j && mine;
      const S f = row[j] / p;
      mult[j] = f;
#pragma unroll
      for (int c = j + 1; c < NX; ++c) {
        if (c < nf) {
          const S pc = __shfl_sync(FULL, row[c], j);
          const S updated = row[c] - f * pc;
          row[c] = below ? updated : row[c];
        }
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      if (c < nf) {
        sm.U[s][lane * NX + c] = row[c];
        if (c < lane) sm.L[s][lane * NX + c] = mult[c];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      if (j < nf) sm.piv[s][j] = piv[j];
  }
}

// Warp 0: M x = u - bias from the factorisation in slot s (the
// elimination's right-hand side, then the back substitution), into x.
template <typename S, int N>
__device__ __forceinline__ void solve(const Smem<S, N>& sm, const S* bias, int nf, int s,
                                      S (&x)[Dims<N>::NB]) {
  constexpr int NX = Dims<N>::NB;
  const S* L = sm.L[s];
  const S* U = sm.U[s];
  S rhs[NX];
#pragma unroll
  for (int r = 0; r < NX; ++r) rhs[r] = r < nf ? sm.u[r] - bias[r] : S(0);
#pragma unroll
  for (int j = 0; j < NX - 1; ++j) {
    if (j < nf - 1) {
#pragma unroll
      for (int r = j + 1; r < NX; ++r)
        if (r < nf) rhs[r] = rhs[r] - L[r * NX + j] * rhs[j];
    }
  }
#pragma unroll
  for (int j = NX - 1; j >= 0; --j) {
    if (j < nf) {
      const S xj = rhs[j] / sm.piv[s][j];
      x[j] = xj;
#pragma unroll
      for (int r = 0; r < j; ++r) rhs[r] = rhs[r] - U[r * NX + j] * xj;
    }
  }
}

template <typename S, int N>
__global__ void __launch_bounds__(THREADS, 1) rollout_kernel(
    const S* __restrict__ spec, const int* __restrict__ ispec, const S* __restrict__ world,
    const S* __restrict__ noise, const S* __restrict__ gains, int B, int n_joints, int n_factors,
    int controller, int n_steps, int log_every, int n_knots, double dt, double knot_ratio,
    double duration_d, double t_plan_d, int traj_orig, S* __restrict__ q_out,
    S* __restrict__ qd_out, S* __restrict__ log_q, S* __restrict__ log_qd,
    S* __restrict__ log_qref, S* __restrict__ log_qdref, S* __restrict__ log_u) {
  constexpr int NX = Dims<N>::NB, CS = Dims<N>::CS;
  constexpr int CTRL_THREADS = THREADS - 64;  // all but the two mass-matrix warps
  __shared__ Smem<S, N> sm;
  __shared__ Work<S, N> wk;
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = N > 0 ? N : n_joints, nf = N > 0 ? N : n_factors;
  for (int e = tid; e < SPEC_LEN; e += THREADS) sm.spec[e] = spec[e];
  for (int e = tid; e < WORLD_LEN; e += THREADS) sm.world[e] = world[(size_t)b * WORLD_LEN + e];
  for (int e = tid; e < MAXJ; e += THREADS) {
    sm.axes[e] = ispec[2 + e];
    sm.cont[e] = ispec[2 + MAXJ + e];
  }
  __syncthreads();
  const S dI = sm.spec[OFF_SCALARS + 5];
  for (int e = tid; e < NX * 9; e += THREADS) sm.absI[e] = dI * fabs(sm.spec[OFF_INERTIA + e]);
  // the trailing fixed joints and the end-effector frame do not move
  for (int e = tid; e < (NX + 1) * 9; e += THREADS) {
    const int i = e / 9;
    if (i >= nf && i <= n)
      sm.Rp[0][e] = sm.Rp[1][e] = sm.Rc[e] = sm.spec[OFF_FIXED + e];
  }
  __syncthreads();

  const S duration = S(duration_d), duration2 = S(duration_d * duration_d), t_plan = S(t_plan_d);
  const double tb = duration_d - t_plan_d;
  const bool orig = traj_orig != 0;
  const S* true_mass = sm.world + W_MASS;
  const S* true_inertia = sm.world + W_INERTIA;
  const S* nom_mass = sm.spec + OFF_MASS;
  const S* nom_inertia = sm.spec + OFF_INERTIA;
  const S* no = nullptr;
  const bool passivity = controller == ROBUST || controller == ALTHOFF || controller == NOMINAL;

  if (warp == 0) {
    // ---- the state, the rotations ahead of use, the solves ----
    const S kr = sm.spec[OFF_SCALARS + 1], alpha = sm.spec[OFF_SCALARS + 2];
    const S v_max = sm.spec[OFF_SCALARS + 3];
    const S h = S(dt), h2 = S(0.5 * dt), h6 = S(dt / 6.0);
    const bool active = lane < nf;
    const int n_log = (n_steps + log_every - 1) / log_every;
    S F[9];
    int axis = 3;
    bool cont = false;
#pragma unroll
    for (int e = 0; e < 9; ++e) F[e] = active ? sm.spec[OFF_FIXED + lane * 9 + e] : S(0);
    if (active) {
      axis = sm.axes[lane];
      cont = sm.cont[lane] != 0;
    }
    // lane j's joint of the state
    S q = active ? sm.world[W_Q + lane] : S(0);
    S qd = active ? sm.world[W_QD + lane] : S(0);
    S i_err = S(0);
    // the next step's measurement noise, read a step ahead
    S nq = 0, nqd = 0;
    if (noise && active) {
      nq = noise[(size_t)b * nf + lane];
      nqd = noise[((size_t)B + b) * nf + lane];
    }
    // lane j's rotation at position x into the buffer R (the fixed frames
    // are there already)
    auto rotate = [&](S x, S* R) {
      if (active) rotation(F, axis, x, R + lane * 9);
    };
    // lane j's share of M x = u - bias with the factorisation in slot s:
    // every lane solves (the same instructions, so the warp stays
    // converged) and keeps its joint's
    auto solved = [&](int s) -> S {
      S x[NX];
      solve<S, N>(sm, wk.bias, nf, s, x);
      S xj = S(0);
#pragma unroll
      for (int c = 0; c < NX; ++c)
        if (c < nf) xj = lane == c ? x[c] : xj;
      return xj;
    };
    // a step's reference (from warp 4's table), measured position and the
    // controller's point, from the step's position x: all but the rates
    S qr = 0, qdr = 0, qddr = 0, qm = 0, nqd_step = 0, err = 0, e = 0;
    auto prepare = [&](int step, S x) {
      bar_sync<BAR_REF, 64>();
      if (!active) return;
      qr = sm.ref[0][lane];
      qdr = sm.ref[1][lane];
      qddr = sm.ref[2][lane];
      qm = x;
      nqd_step = 0;
      if (noise) {
        qm = x + nq;
        nqd_step = nqd;
        if (step + 1 < n_steps) {
          const size_t row = ((size_t)(step + 1) * 2 * B + b) * nf + lane;
          nq = noise[row];
          nqd = noise[row + (size_t)B * nf];
        }
      }
      S cpoint;
      if (passivity) {  // the modified reference of the passivity laws (_passivity_reference)
        err = qr - qm;
        if (cont) err = wrap(err);
        cpoint = qm;
      } else {  // PID and iLQR: the nominal torque along the reference as feedforward
        e = qm - qr;
        if (cont) e = wrap(e);
        cpoint = qr;
      }
      rotation(F, axis, cpoint, sm.Rc + lane * 9);
    };

    // the first position's rotations (M there: warp 2), the first step's point
    rotate(q, sm.Rp[0]);
    bar_arrive<BAR_POS, 64>();
    prepare(0, q);
    for (int i = 0; i < n_steps; ++i) {
      // ---- the controller's inputs: what needs the step's rates ----
      const S qdm = noise ? qd + nqd_step : qd;
      S de = 0;
      if (active) {
        if (passivity) {
          const S d_err = qdr - qdm;
          sm.qdm[lane] = qdm;
          sm.cqd[lane] = qdr + kr * err;
          sm.cqdd[lane] = qddr + kr * d_err;
          sm.r[lane] = d_err + kr * err;
        } else {
          sm.qdm[lane] = qdr;
          sm.cqdd[lane] = qddr;
          de = qdm - qdr;
          if (controller == ILQR) {  // the feedback needs every joint's error
            sm.r[lane] = e;
            sm.cqd[lane] = de;
          }
        }
        sm.ve[lane] = qd;
      }
      bar_sync<BAR_STEP, CTRL_THREADS>();

      // ---- RK4 with the zero-order hold of u: four plant evaluations ----
      // Evaluation k is at position P_k = q + c_k V_{k-1} and rates
      // V_k = qd + c_k KV_{k-1} (P_0 = q, V_0 = qd); P_{k+1} is known once
      // V_k is, so its rotations and M there are made during evaluation k.
      S kq = qd, kv = 0, sq = 0, sv = 0;  // kq: V_k; sq, sv: the RK4 sums
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        const int s = k & 1;
        if (k < 3) {  // the next position's rotations, for its M and bias row
          rotate(q + (k == 2 ? h : h2) * kq, sm.Rp[s ^ 1]);
          bar_arrive_slot<BAR_POS>(s ^ 1);
        } else if (i + 1 < n_steps) {  // the next step's position and point
          const S q_next = q + h6 * (sq + kq);
          rotate(q_next, sm.Rp[0]);
          bar_arrive<BAR_POS, 64>();
          prepare(i + 1, q_next);
        }
        if (k == 0) {
          bar_sync<BAR_CTRL, CTRL_THREADS>();
          // ---- the control law ----
          if (active) {
            S u = 0;
            const S* tau = wk.tau;
            const S* du = wk.du;
            if (controller == NOMINAL) {
              u = tau[lane];
            } else if (controller == ROBUST || controller == ALTHOFF) {
              S phi2 = 0, r2 = 0;
              for (int j = 0; j < nf; ++j) {
                const S phi = S(0.5) * ((tau[j] + du[j]) - (tau[j] - du[j]));
                phi2 += phi * phi;
                r2 += sm.r[j] * sm.r[j];
              }
              const S rho = sqrt(phi2);
              if (controller == ALTHOFF) {
                // kp = (28.1037, 2.0), ki = (2.0, 0.2), e_acc = 0
                u = tau[lane] + (S(2.0) * rho + S(28.1037)) * sm.r[lane];
              } else {
                const S* mrn = wk.mrn;
                const S* mrd = wk.mrd;
                S vs = 0;
                for (int j = 0; j < nf; ++j) {
                  const S rj = sm.r[j];
                  vs += max_nan(rj * (mrn[j] - mrd[j]), rj * (mrn[j] + mrd[j]));
                }
                const S V_sup = S(0.5) * vs;
                const S hh = -V_sup + v_max;
                const S r_norm = sqrt(r2);
                const bool big = r_norm > S(1e-9);
                const S safe = big ? r_norm : S(1);
                S lam = (-alpha * hh) / safe + rho;
                lam = lam < S(0) ? S(0) : lam;
                const S v = big ? (lam * sm.r[lane]) / safe : S(0);
                u = tau[lane] + v;
              }
            } else {
              const S uff = tau[lane];
              if (controller == PID) {
                // k_ff = 1, k_p = 100, k_d = 10, k_i = 0.01
                const S v = (S(-100.0) * e - S(10.0) * de) - S(0.01) * i_err;
                u = S(1.0) * uff + v;
              } else {
                const int knot = min((int)((double)i * knot_ratio), n_knots - 1);
                const S* K = gains + (((size_t)b * n_knots + knot) * nf + lane) * 2 * nf;
                S acc = 0;
                for (int c = 0; c < nf; ++c) acc += K[c] * sm.r[c];
                for (int c = 0; c < nf; ++c) acc += K[nf + c] * sm.cqd[c];
                u = uff + -acc;
              }
            }
            sm.u[lane] = u;
            // the continuous-time integral of the position error (sim/agent.py),
            // taken here, before the next step's point replaces qm and qr
            i_err = i_err + h * (qm - qr);
            // ---- the log: the state before the step, the step's reference and input ----
            if (i % log_every == 0) {
              const size_t o = ((size_t)b * n_log + i / log_every) * nf + lane;
              log_q[o] = q;
              log_qd[o] = qd;
              log_qref[o] = qr;
              log_qdref[o] = qdr;
              log_u[o] = u;
            }
          }
          __syncwarp();
        } else {
          bar_sync<BAR_BIAS, 64>();
        }
        bar_sync_slot<BAR_FACT>(s);
        kv = solved(s);
        // k1 + 2 k2 + 2 k3 + k4, summed in that order
        if (k == 0) {
          sq = kq;
          sv = kv;
        } else if (k < 3) {
          sq = sq + S(2) * kq;
          sv = sv + S(2) * kv;
        } else {
          sq = sq + kq;
          sv = sv + kv;
        }
        if (k < 3) {  // the next evaluation's rates, for its bias row (warp 1)
          kq = qd + (k == 2 ? h : h2) * kv;
          if (active) sm.ve[lane] = kq;
          bar_arrive<BAR_RATES, 64>();
        }
      }
      const S new_q = q + h6 * sq;
      const S new_qd = qd + h6 * sv;
      q = new_q;
      qd = new_qd;
    }
    if (active) {
      q_out[(size_t)b * nf + lane] = q;
      qd_out[(size_t)b * nf + lane] = qd;
    }
  } else if (warp == 1) {
    // ---- the plant's bias rows: one moving pass per evaluation ----
    const LinkForces<S> fn{wk.fn[0], 1};
    for (int i = 0; i < n_steps; ++i) {
      bar_sync<BAR_STEP, CTRL_THREADS>();
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        if (k > 0) bar_sync<BAR_RATES, 64>();
        if (lane == 0)
          rnea<S, N, true, false>(sm, sm.Rp[k & 1], n, nf, sm.ve, sm.ve, no, -1, true_mass,
                                  true_inertia, fn, wk.bias);
        if (k == 0)
          bar_arrive<BAR_CTRL, CTRL_THREADS>();
        else
          bar_arrive<BAR_BIAS, 64>();
      }
    }
  } else if (warp < 4) {
    // ---- the mass matrix at the positions of the even (warp 2) and the
    // odd (warp 3) evaluations, in the order warp 0 makes their rotations:
    // P_0, then per step P_1 .. P_3 and the next step's P_0 ----
    const int m = warp - 2;
    if (m >= Dims<N>::NM) return;  // the run-time instantiation: warp 2 takes both
    const LinkForces<S> fn{wk.fn1[m] + lane, NX};
    auto mass_matrix = [&](int s) {
      bar_sync_slot<BAR_POS>(s);
      if (lane < nf)
        rnea<S, N, false, false>(sm, sm.Rp[s], n, nf, no, no, no, lane, true_mass, true_inertia,
                                 fn, wk.col[m] + lane * CS);
      __syncwarp();
      factor<S, N>(sm, wk.col[m], nf, lane, s);
      bar_arrive_slot<BAR_FACT>(s);
    };
    const bool both = Dims<N>::NM == 1;
    if (m == 0) mass_matrix(0);
    for (int i = 0; i < n_steps; ++i) {
      for (int k = 1; k <= 4; ++k) {
        const int s = k & 1;  // P_1 .. P_3, then P_0 of the next step
        if ((both || s == m) && (k < 4 || i + 1 < n_steps)) mass_matrix(s);
      }
    }
  } else if (warp == 4) {
    // ---- the controller's nominal pass; the next step's reference ----
    const LinkForces<S> fn{wk.fn[1], 1};
    const S t_off = sm.world[W_TOFF];
    auto next_reference = [&](int i) {
      if (lane < nf) {
        const S t = S((double)i * dt) + t_off;
        reference(sm.world, lane, t, duration, duration2, t_plan, tb, orig, sm.ref[0][lane],
                  sm.ref[1][lane], sm.ref[2][lane]);
      }
      bar_arrive<BAR_REF, 64>();
    };
    next_reference(0);
    for (int i = 0; i < n_steps; ++i) {
      bar_sync<BAR_STEP, CTRL_THREADS>();
      if (lane == 0)
        rnea<S, N, true, false>(sm, sm.Rc, n, nf, sm.qdm, passivity ? sm.cqd : sm.qdm, sm.cqdd, -1,
                                nom_mass, nom_inertia, fn, wk.tau);
      bar_arrive<BAR_CTRL, CTRL_THREADS>();
      if (i + 1 < n_steps) next_reference(i + 1);
    }
  } else {
    // ---- warp 5: robust, the nominal pass of the interval M r; warp 6:
    // the controller's absolute-value pass; warp 7: robust, the absolute
    // pass of the interval M r ----
    const LinkForces<S> fn{wk.fn[warp - 3], 1};
    const bool run = warp == 6 ? (controller == ROBUST || controller == ALTHOFF)
                               : controller == ROBUST;
    for (int i = 0; i < n_steps; ++i) {
      bar_sync<BAR_STEP, CTRL_THREADS>();
      if (lane == 0 && run) {
        if (warp == 5)
          rnea<S, N, false, false>(sm, sm.Rc, n, nf, no, no, sm.r, -1, nom_mass, nom_inertia, fn,
                                   wk.mrn);
        else if (warp == 6)
          rnea<S, N, true, true>(sm, sm.Rc, n, nf, sm.qdm, sm.cqd, sm.cqdd, -1, nom_mass,
                                 nom_inertia, fn, wk.du);
        else
          rnea<S, N, false, true>(sm, sm.Rc, n, nf, no, no, sm.r, -1, nom_mass, nom_inertia, fn,
                                  wk.mrd);
      }
      bar_arrive<BAR_CTRL, CTRL_THREADS>();
    }
  }
}

template <typename S>
int launch(int controller, const void* spec, const int* ispec, const void* world,
           const void* noise, const void* gains, int B, int n_joints, int n_factors, int n_steps,
           int log_every, int n_knots, double dt, double knot_ratio, double duration,
           double t_plan, int traj_orig, void* q_out, void* qd_out, void* log_q, void* log_qd,
           void* log_qref, void* log_qdref, void* log_u, cudaStream_t stream) {
#define ARMOUR_ROLLOUT_ARGS                                                                     \
  (const S*)spec, ispec, (const S*)world, (const S*)noise, (const S*)gains, B, n_joints,       \
      n_factors, controller, n_steps, log_every, n_knots, dt, knot_ratio, duration, t_plan,    \
      traj_orig, (S*)q_out, (S*)qd_out, (S*)log_q, (S*)log_qd, (S*)log_qref, (S*)log_qdref,    \
      (S*)log_u
  const int chain = n_joints == n_factors ? n_joints : 0;
  switch (chain) {
    case 7: rollout_kernel<S, 7><<<B, THREADS, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
    default: rollout_kernel<S, 0><<<B, THREADS, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
  }
#undef ARMOUR_ROLLOUT_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The buffer layout this library was compiled with: MAXJ, SPEC_LEN,
// ISPEC_LEN, WORLD_LEN, the threads of a block, then the joint counts with
// an instantiation of their own (the wrapper checks it against its own).
int armour_rollout_layout(int* out) {
  out[0] = MAXJ;
  out[1] = SPEC_LEN;
  out[2] = ISPEC_LEN;
  out[3] = WORLD_LEN;
  out[4] = THREADS;
  for (int k = 0; k < N_SPECIALISED; ++k) out[5 + k] = SPECIALISED[k];
  return 0;
}

// dtype 1 = float32, 2 = float64; controller 0-4 = robust, althoff, nominal,
// pid, ilqr; noise and gains may be null (gains are read by iLQR only).
int armour_rollout(int dtype, int controller, const void* spec, const void* ispec,
                   const void* world, const void* noise, const void* gains, int B, int n_joints,
                   int n_factors, int n_steps, int log_every, int n_knots, double dt,
                   double knot_ratio, double duration, double t_plan, int traj_orig, void* q_out,
                   void* qd_out, void* log_q, void* log_qd, void* log_qref, void* log_qdref,
                   void* log_u, void* stream) {
  if (B <= 0 || n_steps <= 0 || log_every <= 0 || controller < ROBUST || controller > ILQR ||
      n_factors < 1 || n_factors > n_joints || n_joints > MAXJ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* is = (const int*)ispec;
  if (dtype == 1)
    return launch<float>(controller, spec, is, world, noise, gains, B, n_joints, n_factors,
                         n_steps, log_every, n_knots, dt, knot_ratio, duration, t_plan, traj_orig,
                         q_out, qd_out, log_q, log_qd, log_qref, log_qdref, log_u, s);
  if (dtype == 2)
    return launch<double>(controller, spec, is, world, noise, gains, B, n_joints, n_factors,
                          n_steps, log_every, n_knots, dt, knot_ratio, duration, t_plan, traj_orig,
                          q_out, qd_out, log_q, log_qd, log_qref, log_qdref, log_u, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
