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
// Both are one loop (bank_pass below): the values-only kernel drops the
// Jacobian epilogue.
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
// Design: one thread per (b, l, o, t), t fastest, so every load and store
// of the bank and the outputs coalesces along T.  Each thread keeps best[s]
// and the winning signed normal for all S starts in registers, so the bank
// slab is read from device memory ONCE for all starts (the point of the
// _multi kernel, pallas_kernel.py:109-112).  S is bounded by a template
// parameter: 1, 4 or 8 starts with the Jacobian (seven register arrays),
// and up to 16 for the values-only kernel (four arrays, no normals), which
// serves the planner's verification pool of 2S + 2 candidates in one pass.
//
// Bound: memory.  Per launch the kernel must read the bank once and write g
// and J once; the arithmetic is ~10 operations per (slot, start, pair).  At
// the main path's shapes (B=128, S=4, n=7, L=7, O=8, T=128, bf16 A, f32
// offsets): 198 MB of A + 264 MB of offsets + 44 MB of c/dc + 118 MB of
// g/J = 624 MB per launch (2.94 GB at O=40).  This first version stages
// nothing through shared memory (no TMA / cp.async pipeline yet).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

constexpr int kThreads = 128;

template <typename AT, typename OT, int MAXS, bool JAC>
__global__ void __launch_bounds__(kThreads) bank_pass(
    const AT* __restrict__ A, const OT* __restrict__ dpos, const OT* __restrict__ dneg,
    const OT* __restrict__ c, const OT* __restrict__ dc, OT* __restrict__ g,
    OT* __restrict__ J, int P, int L, int O, int T, int S, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int lo = blockIdx.y;  // l * O + o
  const int l = lo / O;
  const int64_t b = blockIdx.z;
  const int64_t LT = (int64_t)L * T;
  const int64_t LOT = (int64_t)L * O * T;
  const int64_t slot = (int64_t)lo * T + t;  // offset inside one (L,O,T) slab

  constexpr int NJ = JAC ? MAXS : 1;  // no normals are kept without the Jacobian
  OT cx[MAXS], cy[MAXS], cz[MAXS], best[MAXS], a0[NJ], a1[NJ], a2[NJ];
#pragma unroll
  for (int s = 0; s < NJ; ++s) a0[s] = a1[s] = a2[s] = static_cast<OT>(0);
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    best[s] = static_cast<OT>(-1e30);
    cx[s] = cy[s] = cz[s] = static_cast<OT>(0);
    if (s < S) {
      const OT* cs = c + (b * S + s) * 3 * LT + (int64_t)l * T + t;
      cx[s] = cs[0];
      cy[s] = cs[LT];
      cz[s] = cs[2 * LT];
    }
  }

  const AT* Ab = A + b * P * 3 * LOT + slot;
  const OT* Dp = dpos + b * P * LOT + slot;
  const OT* Dn = dneg + b * P * LOT + slot;
  for (int p = 0; p < P; ++p) {
    const OT A0 = upcast<AT, OT>(Ab[(int64_t)(3 * p + 0) * LOT]);
    const OT A1 = upcast<AT, OT>(Ab[(int64_t)(3 * p + 1) * LOT]);
    const OT A2 = upcast<AT, OT>(Ab[(int64_t)(3 * p + 2) * LOT]);
    const OT dp = Dp[(int64_t)p * LOT];
    const OT dn = Dn[(int64_t)p * LOT];
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
      if (s < S) {
        const OT Ac = A0 * cx[s] + A1 * cy[s] + A2 * cz[s];
        const OT vp = Ac - dp;
        const OT vn = -Ac - dn;
        const bool pos = vp >= vn;
        const OT v = pos ? vp : vn;
        // strict '>': the first maximum wins; (x == x) is false for NaN
        if (vp == vp && vn == vn && v > best[s]) {
          best[s] = v;
          if constexpr (JAC) {
            const OT sg = pos ? static_cast<OT>(-1) : static_cast<OT>(1);
            a0[s] = sg * A0;
            a1[s] = sg * A1;
            a2[s] = sg * A2;
          }
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    if (s < S) {
      const int64_t bs = b * S + s;
      g[bs * LOT + slot] = -best[s];
      if constexpr (JAC) {
        for (int i = 0; i < n; ++i) {
          const OT* d = dc + (bs * n + i) * 3 * LT + (int64_t)l * T + t;
          J[(bs * n + i) * LOT + slot] = a0[s] * d[0] + a1[s] * d[LT] + a2[s] * d[2 * LT];
        }
      }
    }
  }
}

template <typename AT, typename OT, bool JAC>
int launch(const void* A, const void* dpos, const void* dneg, const void* c, const void* dc,
           void* g, void* J, int B, int P, int L, int O, int T, int S, int n,
           cudaStream_t stream) {
  if (B < 1 || P < 1 || L < 1 || O < 1 || T < 1 || S < 1 || (JAC && n < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)L * O > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kThreads);
  const dim3 grid((T + kThreads - 1) / kThreads, L * O, B);
  const AT* a = static_cast<const AT*>(A);
  const OT* p = static_cast<const OT*>(dpos);
  const OT* m = static_cast<const OT*>(dneg);
  const OT* cc = static_cast<const OT*>(c);
  const OT* dd = static_cast<const OT*>(dc);
  OT* gg = static_cast<OT*>(g);
  OT* jj = static_cast<OT*>(J);
  if (S <= 1) {
    bank_pass<AT, OT, 1, JAC><<<grid, block, 0, stream>>>(a, p, m, cc, dd, gg, jj, P, L, O, T, S, n);
  } else if (S <= 4) {
    bank_pass<AT, OT, 4, JAC><<<grid, block, 0, stream>>>(a, p, m, cc, dd, gg, jj, P, L, O, T, S, n);
  } else if (S <= 8) {
    bank_pass<AT, OT, 8, JAC><<<grid, block, 0, stream>>>(a, p, m, cc, dd, gg, jj, P, L, O, T, S, n);
  } else {
    if constexpr (!JAC) {
      if (S <= 16) {
        bank_pass<AT, OT, 16, false><<<grid, block, 0, stream>>>(a, p, m, cc, dd, gg, jj, P, L, O, T, S, n);
        return (int)cudaGetLastError();
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype codes: 0 = bfloat16, 1 = float32, 2 = float64.  A is stored in a
// type no wider than the offsets'.
template <bool JAC>
int dispatch(const void* A, int a_dtype, const void* dpos, const void* dneg, int o_dtype,
             const void* c, const void* dc, void* g, void* J, int B, int P, int L, int O,
             int T, int S, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (o_dtype == 1) {
    if (a_dtype == 0)
      return launch<__nv_bfloat16, float, JAC>(A, dpos, dneg, c, dc, g, J, B, P, L, O, T, S, n, st);
    if (a_dtype == 1)
      return launch<float, float, JAC>(A, dpos, dneg, c, dc, g, J, B, P, L, O, T, S, n, st);
  } else if (o_dtype == 2) {
    if (a_dtype == 0)
      return launch<__nv_bfloat16, double, JAC>(A, dpos, dneg, c, dc, g, J, B, P, L, O, T, S, n, st);
    if (a_dtype == 1)
      return launch<float, double, JAC>(A, dpos, dneg, c, dc, g, J, B, P, L, O, T, S, n, st);
    if (a_dtype == 2)
      return launch<double, double, JAC>(A, dpos, dneg, c, dc, g, J, B, P, L, O, T, S, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Value + k-Jacobian for S <= 8 starts in one bank pass.
int armour_collision_value_jac_multi(const void* A, int a_dtype, const void* dpos,
                                     const void* dneg, int o_dtype, const void* c,
                                     const void* dc, void* g, void* J, int B, int P, int L,
                                     int O, int T, int S, int n, void* stream) {
  return dispatch<true>(A, a_dtype, dpos, dneg, o_dtype, c, dc, g, J, B, P, L, O, T, S, n,
                        stream);
}

// Values only for S <= 16 starts in one bank pass.
int armour_collision_values_multi(const void* A, int a_dtype, const void* dpos,
                                  const void* dneg, int o_dtype, const void* c, void* g, int B,
                                  int P, int L, int O, int T, int S, void* stream) {
  return dispatch<false>(A, a_dtype, dpos, dneg, o_dtype, c, nullptr, g, nullptr, B, P, L, O,
                         T, S, 0, stream);
}

}  // extern "C"
