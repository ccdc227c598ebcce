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
//   * the controller (template CTRL: robust, althoff, nominal passivity, PID,
//     iLQR; control/robust.py, control/ilqr.py) on the measured state
//     q + noise[i, 0], qd + noise[i, 1], with the nominal link constants;
//   * four plant evaluations with the true parameters: M(q) from nf
//     unit-acceleration RNEA rows (no gravity, armature on the diagonal) and
//     the bias row (qdd = 0, gravity, damping), then M x = u - bias by the
//     LDL^T elimination of ops/linalg.py::spd_solve_small (pivots clamped at
//     1e-30);
//   * the RK4 combination with the zero-order hold of u, and i_err += dt e_pos;
//   * every log_every steps, q and qd before the step and the step's q_ref,
//     qd_ref and u: the rows the plain version's host loop keeps.
// There is no fast math and no tensor-core arithmetic: full-precision sin,
// cos, division and square root.  nvcc contracts a*b + c into FMAs, so the
// last bits differ from the plain version's; the card tests state the
// tolerances (f64 1e-9 on the end state; f32 1e-4 rad, 1e-3 rad/s).
//
// Layout: one warp (one block of 32 threads) per world, everything in
// shared memory.  Lane j owns joint j of every per-joint vector (the
// reference, the measured state, the RK4 stages and sums, the log rows);
// lane i computes the rotation of joint i at each evaluation point; lane l
// runs RNEA pass l: the plant's nf + 1 stacked rows (M columns and the bias
// row), or the controller's passes (robust: nominal and absolute-value
// backward passes of rnea_with_bound at the modified reference, and of the
// interval M r pass).  Lanes r > j eliminate row r at pivot j in parallel;
// the back substitution likewise.  __syncwarp orders the shared memory
// between the stages.
//
// Bound: the dependency chain.  The steps are serial (step i + 1 needs the
// state of step i), and inside a step the four plant evaluations and the
// controller are serial too; each evaluation is a forward and a backward
// recursion over the joints (a chain of ~n x 40 dependent operations) and an
// nf-pivot elimination.  The arithmetic per world and step is ~4 x (nf + 1)
// RNEA passes of ~1,800 operations and the controller's, about 70,000 for the
// Kinova (sim/rollout_kernel.py::operation_count); at B = 128 a 1,000-step
// move is 9 GFLOP, 0.13 ms of the card's f32 peak.  The chain of dependent
// operations is ~1,200 per step (dependent_ops_per_step), ~2.4 ms per move
// at 4 cycles each and 1.98 GHz.  What bounds the kernel is the latency of
// that chain and of the shared memory and the warp barriers on it, which one
// warp per world cannot hide (B <= 132 worlds put one warp on each SM).
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
constexpr int NL = MAXJ + 1;    // lanes that run RNEA passes (nf + 1 plant rows) or rotations (n + 1)

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

enum { ROBUST = 0, ALTHOFF = 1, NOMINAL = 2, PID = 3, ILQR = 4 };

constexpr double PI = 3.14159265358979323846;

template <typename S>
struct Smem {
  S spec[SPEC_LEN];
  S world[WORLD_LEN];
  S R[(MAXJ + 1) * 9];          // joint rotations at the current evaluation point
  S FN[MAXJ * 6 * NL];          // per lane: F and N of each joint, lane fastest
  S col[NL * MAXJ];             // RNEA outputs: col[l * MAXJ + j]
  S A[MAXJ * (MAXJ + 1)];       // [M | u - bias], eliminated in place
  S piv[MAXJ], x[MAXJ], xo[MAXJ];
  S qe[MAXJ], ve[MAXJ];         // the evaluation point (plant stage, or controller)
  S qdm[MAXJ], cqd[MAXJ], cqdd[MAXJ], r[MAXJ];
  S u[MAXJ];
  int axes[MAXJ], cont[MAXJ];
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
  for (int a = 0; a < 3; ++a) o[a] = M[a * 3] * v[0] + M[a * 3 + 1] * v[1] + M[a * 3 + 2] * v[2];
}

// M^T v
template <typename S>
__device__ __forceinline__ void mul_t(const S* M, const S* v, S* o) {
  for (int a = 0; a < 3; ++a) o[a] = M[a] * v[0] + M[3 + a] * v[1] + M[6 + a] * v[2];
}

// |M| v
template <typename S>
__device__ __forceinline__ void mul_abs(const S* M, const S* v, S* o) {
  for (int a = 0; a < 3; ++a)
    o[a] = fabs(M[a * 3]) * v[0] + fabs(M[a * 3 + 1]) * v[1] + fabs(M[a * 3 + 2]) * v[2];
}

// (c * |M|) v, the scaled absolute inertia of rnea_with_bound
template <typename S>
__device__ __forceinline__ void mul_abs_scaled(const S* M, S c, const S* v, S* o) {
  for (int a = 0; a < 3; ++a)
    o[a] = (c * fabs(M[a * 3])) * v[0] + (c * fabs(M[a * 3 + 1])) * v[1] +
           (c * fabs(M[a * 3 + 2])) * v[2];
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
__device__ void reference(const Smem<S>& sm, int j, S tt, S duration, S duration2, S t_plan,
                          double tb, bool orig, S& q, S& qd, S& qdd) {
  const S* w = sm.world;
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

// lane i <= n: the rotation of joint i at sm.qe (rnea.py::joint_rotations)
template <typename S>
__device__ void rotations(Smem<S>& sm, int n, int nf, int lane) {
  if (lane > n) return;
  const S* F = sm.spec + OFF_FIXED + lane * 9;
  S* R = sm.R + lane * 9;
  if (lane >= nf) {  // trailing fixed joints and the end-effector frame
    for (int e = 0; e < 9; ++e) R[e] = F[e];
    return;
  }
  const int axis = sm.axes[lane];
  const int a = abs(axis) - 1, jj = (a + 1) % 3, kk = (a + 2) % 3;
  const S sgn = axis > 0 ? S(1) : S(-1);
  const S s = sin(sm.qe[lane]), c = cos(sm.qe[lane]);
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
    for (int b = 0; b < 3; ++b)
      R[r * 3 + b] = F[r * 3] * J[b] + F[r * 3 + 1] * J[3 + b] + F[r * 3 + 2] * J[6 + b];
}

// One modified-RNEA pass of this lane at the rotations in sm.R: the forward
// recursion (rnea.py::_forward_pass) and the nominal backward pass with
// ``mass``/``inertia`` (_backward_pass, with armature and damping), or with
// ``absmode`` the absolute-value pass of rnea_with_bound (dm * mass,
// dI * |inertia|).  qd/qda/qdd are shared vectors or null (zero); unit >= 0
// makes qdd the unit vector e_unit.  Writes the nf joint torques to out.
template <typename S>
__device__ void rnea_pass(Smem<S>& sm, int n, int nf, int lane, const S* qd, const S* qda,
                          const S* qdd, int unit, bool gravity, const S* mass,
                          const S* inertia, bool absmode, S* out) {
  const S* sp = sm.spec;
  const S dm = sp[OFF_SCALARS + 4], dI = sp[OFF_SCALARS + 5];
  S w[3] = {0, 0, 0}, wa[3] = {0, 0, 0}, wd[3] = {0, 0, 0};
  S acc[3] = {0, 0, gravity ? sp[OFF_SCALARS] : S(0)};
  S t1[3], t2[3], t3[3], v[3];
  for (int i = 0; i < n; ++i) {
    const S* R = sm.R + i * 9;
    const S* P = sp + OFF_TRANS + i * 3;
    cross(wd, P, t1);
    cross(wa, P, t2);
    cross(w, t2, t3);
    for (int c = 0; c < 3; ++c) v[c] = acc[c] + t1[c] + t3[c];
    mul_t(R, v, acc);
    mul_t(R, w, v);
    for (int c = 0; c < 3; ++c) w[c] = v[c];
    mul_t(R, wa, v);
    for (int c = 0; c < 3; ++c) wa[c] = v[c];
    mul_t(R, wd, v);
    for (int c = 0; c < 3; ++c) wd[c] = v[c];
    const int axis = sm.axes[i];
    if (axis != 0) {
      const int a = abs(axis) - 1;
      const S sgn = axis > 0 ? S(1) : S(-1);
      const S qdd_i = unit >= 0 ? (i == unit ? S(1) : S(0)) : (qdd ? qdd[i] : S(0));
      const S zq_a = (qd ? qd[i] : S(0)) * sgn, zqa_a = (qda ? qda[i] : S(0)) * sgn;
      const S zqdd_a = qdd_i * sgn;
      S zq[3], zqa[3], zqdd[3];  // the joint-rate vectors along the signed axis
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        zq[c] = c == a ? zq_a : S(0);
        zqa[c] = c == a ? zqa_a : S(0);
        zqdd[c] = c == a ? zqdd_a : S(0);
      }
      for (int c = 0; c < 3; ++c) w[c] = w[c] + zq[c];
      cross(wa, zq, t1);
      for (int c = 0; c < 3; ++c) wd[c] = wd[c] + t1[c] + zqdd[c];
      for (int c = 0; c < 3; ++c) wa[c] = wa[c] + zqa[c];
    }
    // this joint's force and moment (the backward pass's per-link terms)
    const S* ci = sp + OFF_COM + i * 3;
    const S* I = inertia + i * 9;
    cross(wd, ci, t1);
    cross(wa, ci, t2);
    cross(w, t2, t3);
    S ac[3];
    for (int c = 0; c < 3; ++c) ac[c] = acc[c] + t1[c] + t3[c];
    S* FN = sm.FN + i * 6 * NL + lane;
    if (!absmode) {
      for (int c = 0; c < 3; ++c) FN[c * NL] = mass[i] * ac[c];
      mul(I, wd, t1);
      mul(I, w, t2);
      cross(wa, t2, t3);
      for (int c = 0; c < 3; ++c) FN[(3 + c) * NL] = t1[c] + t3[c];
    } else {
      const S m = dm * mass[i];
      for (int c = 0; c < 3; ++c) FN[c * NL] = m * fabs(ac[c]);
      S aw[3] = {fabs(w[0]), fabs(w[1]), fabs(w[2])};
      S awd[3] = {fabs(wd[0]), fabs(wd[1]), fabs(wd[2])};
      S awa[3] = {fabs(wa[0]), fabs(wa[1]), fabs(wa[2])};
      mul_abs_scaled(I, dI, aw, t2);
      mul_abs_scaled(I, dI, awd, t1);
      abs_cross(awa, t2, t3);
      for (int c = 0; c < 3; ++c) FN[(3 + c) * NL] = t1[c] + t3[c];
    }
  }
  // backward recursion
  S f[3] = {0, 0, 0}, nn[3] = {0, 0, 0}, Rf[3];
  for (int i = n - 1; i >= 0; --i) {
    const S* Rn = sm.R + (i + 1) * 9;
    const S* FN = sm.FN + i * 6 * NL + lane;
    const S Fi[3] = {FN[0], FN[NL], FN[2 * NL]};
    const S Ni[3] = {FN[3 * NL], FN[4 * NL], FN[5 * NL]};
    const S* ci = sp + OFF_COM + i * 3;
    const S* Pn = sp + OFF_TRANS + (i + 1) * 3;
    if (!absmode) {
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
    for (int c = 0; c < 3; ++c) nn[c] = Ni[c] + t1[c] + t2[c] + t3[c];
    for (int c = 0; c < 3; ++c) f[c] = Rf[c] + Fi[c];
    const int axis = sm.axes[i];
    if (axis != 0) {
      const int a = abs(axis) - 1;
      const S m = a == 0 ? nn[0] : (a == 1 ? nn[1] : nn[2]);
      out[i] = absmode ? m : (axis > 0 ? m : -m);
    }
  }
  if (!absmode) {
    for (int j = 0; j < nf; ++j) {
      const S qdd_j = unit >= 0 ? (j == unit ? S(1) : S(0)) : (qdd ? qdd[j] : S(0));
      out[j] = out[j] + sp[OFF_ARMATURE + j] * qdd_j;
      out[j] = out[j] + sp[OFF_DAMPING + j] * (qd ? qd[j] : S(0));
    }
  }
}

// The plant's acceleration at (sm.qe, sm.ve) under the input sm.u: lane j < nf
// returns x_j of M x = u - bias.
template <typename S>
__device__ S plant_acc(Smem<S>& sm, int n, int nf, int lane) {
  rotations(sm, n, nf, lane);
  __syncwarp();
  if (lane <= nf) {
    const bool bias = lane == nf;
    rnea_pass(sm, n, nf, lane, bias ? sm.ve : (const S*)nullptr, bias ? sm.ve : (const S*)nullptr,
              (const S*)nullptr, bias ? -1 : lane, bias, sm.world + W_MASS, sm.world + W_INERTIA,
              false, sm.col + lane * MAXJ);
  }
  __syncwarp();
  // the augmented system: M[r][c] = column c's row r
  if (lane < nf) {
    for (int c = 0; c < nf; ++c) sm.A[lane * (MAXJ + 1) + c] = sm.col[c * MAXJ + lane];
    sm.A[lane * (MAXJ + 1) + nf] = sm.u[lane] - sm.col[nf * MAXJ + lane];
  }
  __syncwarp();
  // LDL^T elimination, one pivot at a time, rows below the pivot in parallel
  for (int j = 0; j < nf; ++j) {
    S p = sm.A[j * (MAXJ + 1) + j];
    p = p < S(1e-30) ? S(1e-30) : p;
    if (lane == 0) sm.piv[j] = p;
    if (j < nf - 1 && lane > j && lane < nf) {
      S* row = sm.A + lane * (MAXJ + 1);
      const S* prow = sm.A + j * (MAXJ + 1);
      const S f = row[j] / p;
      for (int c = j + 1; c <= nf; ++c) row[c] = row[c] - f * prow[c];
    }
    __syncwarp();
  }
  if (lane < nf) sm.x[lane] = sm.A[lane * (MAXJ + 1) + nf];
  __syncwarp();
  for (int j = nf - 1; j >= 0; --j) {
    const S xj = sm.x[j] / sm.piv[j];
    if (lane == j) sm.xo[j] = xj;
    if (lane < j) sm.x[lane] = sm.x[lane] - sm.A[lane * (MAXJ + 1) + j] * xj;
    __syncwarp();
  }
  return lane < nf ? sm.xo[lane] : S(0);
}

template <typename S, int CTRL>
__global__ void __launch_bounds__(32) rollout_kernel(
    const S* __restrict__ spec, const int* __restrict__ ispec, const S* __restrict__ world,
    const S* __restrict__ noise, const S* __restrict__ gains, int B, int n_steps, int log_every,
    int n_knots, double dt, double knot_ratio, double duration_d, double t_plan_d, int traj_orig,
    S* __restrict__ q_out, S* __restrict__ qd_out, S* __restrict__ log_q, S* __restrict__ log_qd,
    S* __restrict__ log_qref, S* __restrict__ log_qdref, S* __restrict__ log_u) {
  __shared__ Smem<S> sm;
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int e = lane; e < SPEC_LEN; e += 32) sm.spec[e] = spec[e];
  for (int e = lane; e < WORLD_LEN; e += 32) sm.world[e] = world[(size_t)b * WORLD_LEN + e];
  const int n = ispec[0], nf = ispec[1];
  for (int e = lane; e < MAXJ; e += 32) {
    sm.axes[e] = ispec[2 + e];
    sm.cont[e] = ispec[2 + MAXJ + e];
  }
  __syncwarp();

  const S kr = sm.spec[OFF_SCALARS + 1], alpha = sm.spec[OFF_SCALARS + 2];
  const S v_max = sm.spec[OFF_SCALARS + 3];
  const S duration = S(duration_d), duration2 = S(duration_d * duration_d), t_plan = S(t_plan_d);
  const double tb = duration_d - t_plan_d;
  const S h = S(dt), h2 = S(0.5 * dt), h6 = S(dt / 6.0);
  const bool orig = traj_orig != 0;
  const bool active = lane < nf;
  const int n_log = (n_steps + log_every - 1) / log_every;

  // lane j's joint of the state
  S q = active ? sm.world[W_Q + lane] : S(0);
  S qd = active ? sm.world[W_QD + lane] : S(0);
  S i_err = S(0);
  const S t_off = sm.world[W_TOFF];

  for (int i = 0; i < n_steps; ++i) {
    // ---- the reference at the step's time, the measured state ----
    S qr = 0, qdr = 0, qddr = 0, qm = q, qdm = qd;
    if (active) {
      const S t = S((double)i * dt) + t_off;
      reference(sm, lane, t, duration, duration2, t_plan, tb, orig, qr, qdr, qddr);
      if (noise) {
        const size_t row = ((size_t)i * 2 * B + b) * nf + lane;
        qm = q + noise[row];
        qdm = qd + noise[row + (size_t)B * nf];
      }
    }
    // ---- the controller ----
    S u = 0;
    if (CTRL == ROBUST || CTRL == ALTHOFF || CTRL == NOMINAL) {
      // the modified reference of the passivity laws (_passivity_reference)
      if (active) {
        S err = qr - qm;
        if (sm.cont[lane]) err = wrap(err);
        const S d_err = qdr - qdm;
        sm.qe[lane] = qm;
        sm.qdm[lane] = qdm;
        sm.cqd[lane] = qdr + kr * err;
        sm.cqdd[lane] = qddr + kr * d_err;
        sm.r[lane] = d_err + kr * err;
      }
      __syncwarp();
      rotations(sm, n, nf, lane);
      __syncwarp();
      const int tasks = CTRL == ROBUST ? 4 : (CTRL == ALTHOFF ? 2 : 1);
      if (lane < tasks) {
        const bool mr = lane >= 2;  // robust lanes 2-3: the interval M r pass
        rnea_pass(sm, n, nf, lane, mr ? (const S*)nullptr : sm.qdm,
                  mr ? (const S*)nullptr : sm.cqd, mr ? sm.r : sm.cqdd, -1, !mr,
                  sm.spec + OFF_MASS, sm.spec + OFF_INERTIA, (lane & 1) != 0,
                  sm.col + lane * MAXJ);
      }
      __syncwarp();
      if (active) {
        const S* tau = sm.col;
        const S* du = sm.col + MAXJ;
        if (CTRL == NOMINAL) {
          u = tau[lane];
        } else {
          S phi2 = 0, r2 = 0;
          for (int j = 0; j < nf; ++j) {
            const S phi = S(0.5) * ((tau[j] + du[j]) - (tau[j] - du[j]));
            phi2 += phi * phi;
            r2 += sm.r[j] * sm.r[j];
          }
          const S rho = sqrt(phi2);
          if (CTRL == ALTHOFF) {
            // kp = (28.1037, 2.0), ki = (2.0, 0.2), e_acc = 0
            u = tau[lane] + (S(2.0) * rho + S(28.1037)) * sm.r[lane];
          } else {
            const S* mrn = sm.col + 2 * MAXJ;
            const S* mrd = sm.col + 3 * MAXJ;
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
        }
      }
    } else {  // PID and iLQR: the nominal torque along the reference as feedforward
      if (active) {
        sm.qe[lane] = qr;
        sm.qdm[lane] = qdr;
        sm.cqdd[lane] = qddr;
      }
      __syncwarp();
      rotations(sm, n, nf, lane);
      __syncwarp();
      if (lane == 0)
        rnea_pass(sm, n, nf, lane, sm.qdm, sm.qdm, sm.cqdd, -1, true, sm.spec + OFF_MASS,
                  sm.spec + OFF_INERTIA, false, sm.col);
      S e = 0, de = 0;
      if (active) {
        e = qm - qr;
        if (sm.cont[lane]) e = wrap(e);
        de = qdm - qdr;
      }
      if (CTRL == ILQR && active) {  // the feedback needs every joint's error
        sm.r[lane] = e;
        sm.cqd[lane] = de;
      }
      __syncwarp();
      if (active) {
        const S uff = sm.col[lane];
        if (CTRL == PID) {
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
    }
    __syncwarp();
    if (active) sm.u[lane] = u;

    // ---- the log: the state before the step, the step's reference and input ----
    if (active && i % log_every == 0) {
      const size_t o = ((size_t)b * n_log + i / log_every) * nf + lane;
      log_q[o] = q;
      log_qd[o] = qd;
      log_qref[o] = qr;
      log_qdref[o] = qdr;
      log_u[o] = u;
    }

    // ---- RK4 with the zero-order hold of u ----
    if (active) {
      sm.qe[lane] = q;
      sm.ve[lane] = qd;
    }
    __syncwarp();
    const S k1q = qd, k1v = plant_acc(sm, n, nf, lane);
    const S q2 = q + h2 * k1q, v2 = qd + h2 * k1v;
    if (active) {
      sm.qe[lane] = q2;
      sm.ve[lane] = v2;
    }
    __syncwarp();
    const S k2q = v2, k2v = plant_acc(sm, n, nf, lane);
    const S q3 = q + h2 * k2q, v3 = qd + h2 * k2v;
    if (active) {
      sm.qe[lane] = q3;
      sm.ve[lane] = v3;
    }
    __syncwarp();
    const S k3q = v3, k3v = plant_acc(sm, n, nf, lane);
    const S q4 = q + h * k3q, v4 = qd + h * k3v;
    if (active) {
      sm.qe[lane] = q4;
      sm.ve[lane] = v4;
    }
    __syncwarp();
    const S k4q = v4, k4v = plant_acc(sm, n, nf, lane);
    const S new_q = q + h6 * (k1q + S(2) * k2q + S(2) * k3q + k4q);
    const S new_qd = qd + h6 * (k1v + S(2) * k2v + S(2) * k3v + k4v);
    // the continuous-time integral of the position error (sim/agent.py)
    i_err = i_err + h * (qm - qr);
    q = new_q;
    qd = new_qd;
    __syncwarp();
  }
  if (active) {
    q_out[(size_t)b * nf + lane] = q;
    qd_out[(size_t)b * nf + lane] = qd;
  }
}

template <typename S>
int launch(int controller, const void* spec, const int* ispec, const void* world,
           const void* noise, const void* gains, int B, int n_steps, int log_every, int n_knots,
           double dt, double knot_ratio, double duration, double t_plan, int traj_orig,
           void* q_out, void* qd_out, void* log_q, void* log_qd, void* log_qref, void* log_qdref,
           void* log_u, cudaStream_t stream) {
#define ARMOUR_ROLLOUT_ARGS                                                                    \
  (const S*)spec, ispec, (const S*)world, (const S*)noise, (const S*)gains, B, n_steps,       \
      log_every, n_knots, dt, knot_ratio, duration, t_plan, traj_orig, (S*)q_out, (S*)qd_out, \
      (S*)log_q, (S*)log_qd, (S*)log_qref, (S*)log_qdref, (S*)log_u
  switch (controller) {
    case ROBUST: rollout_kernel<S, ROBUST><<<B, 32, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
    case ALTHOFF: rollout_kernel<S, ALTHOFF><<<B, 32, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
    case NOMINAL: rollout_kernel<S, NOMINAL><<<B, 32, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
    case PID: rollout_kernel<S, PID><<<B, 32, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
    case ILQR: rollout_kernel<S, ILQR><<<B, 32, 0, stream>>>(ARMOUR_ROLLOUT_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARMOUR_ROLLOUT_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The buffer layout this library was compiled with: MAXJ, SPEC_LEN,
// ISPEC_LEN, WORLD_LEN (the wrapper checks it against its own).
int armour_rollout_layout(int* out) {
  out[0] = MAXJ;
  out[1] = SPEC_LEN;
  out[2] = ISPEC_LEN;
  out[3] = WORLD_LEN;
  return 0;
}

// dtype 1 = float32, 2 = float64; controller 0-4 = robust, althoff, nominal,
// pid, ilqr; noise and gains may be null (gains are read by iLQR only).
int armour_rollout(int dtype, int controller, const void* spec, const void* ispec,
                   const void* world, const void* noise, const void* gains, int B, int n_steps,
                   int log_every, int n_knots, double dt, double knot_ratio, double duration,
                   double t_plan, int traj_orig, void* q_out, void* qd_out, void* log_q,
                   void* log_qd, void* log_qref, void* log_qdref, void* log_u, void* stream) {
  if (B <= 0 || n_steps <= 0 || log_every <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* is = (const int*)ispec;
  if (dtype == 1)
    return launch<float>(controller, spec, is, world, noise, gains, B, n_steps, log_every,
                         n_knots, dt, knot_ratio, duration, t_plan, traj_orig, q_out, qd_out,
                         log_q, log_qd, log_qref, log_qdref, log_u, s);
  if (dtype == 2)
    return launch<double>(controller, spec, is, world, noise, gains, B, n_steps, log_every,
                          n_knots, dt, knot_ratio, duration, t_plan, traj_orig, q_out, qd_out,
                          log_q, log_qd, log_qref, log_qdref, log_u, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
