// K4: the traced-smoothness general Matern, a device function hand-written
// for Hopper and inlined in K1, K1b (fused_predict.cu) and K2
// (fused_train.cu).
//
// Replaces muygpys_tpu/pallas/matern_nu.py:matern_nu_eval.  From the flat
// coefficient vector of muygpys_torch/gpu/matern_nu.py:matern_nu_coeffs it
// evaluates, for one scaled distance t = sqrt(2 nu) d / ls,
//   phi_nu(t) = 2^{1-nu}/Gamma(nu) t^nu K_nu(t)
// and on request d phi/dt and the partial d phi/d nu at fixed t:
//   t <= 0        phi = 1, both derivatives 0
//   t <= T0       phi = P(w) + expm1(mu ln w) w^n Q(w),  w = max(t^2/4, 1e-30)
//                 (two Horner chains of KSM = 14 terms, one log, two exp)
//   t >  T0       phi = exp(g(s) - t), g a Chebyshev series in
//                 s = (min(t, TMAX) - S_MID) / S_HALF (Clenshaw over `nt`
//                 leading terms; ds/dt = 0 beyond TMAX)
// The vector (73 scalars for the value, 139 with the d/dt sets, 207 with the
// nu-tangent sets) is a runtime input, so one build serves every nu.
//
// What bounds it on an H100: ~10^2 multiply-adds and 1-3 transcendentals per
// element from coefficients every thread reads at the same index: operations.
// Design: written for a thread, not carried over from the TPU's whole-tile
// form.  One element takes ONE branch (the Pallas body computed both over
// the tile and selected); a warp whose lanes straddle t = T0 runs both, one
// after the other.  The coefficients are staged ONCE PER BLOCK in shared
// memory by stage() (every lane reads the same address: a broadcast, no bank
// conflict) rather than passed by value, so K2 can re-derive the d/ds
// Chebyshev coefficients of a truncated tail in place (the derivative
// returned is exactly that of the truncated phi).  No fast-math: logf/expf
// at full precision.

#pragma once

namespace matern_nu {

constexpr int KSM = 14;    // series terms on t <= T0
constexpr int NTAIL = 40;  // Chebyshev coefficients on [T0, TMAX]
constexpr double T0 = 2.0;
constexpr double TMAX = 42.0;
constexpr double S_MID = 0.5 * (T0 + TMAX);
constexpr double S_HALF = 0.5 * (TMAX - T0);

// flat layout: [sqrt(2 nu), n, mu, gate, 1/(2 nu)], a, b, c | ap, bp, cp |
// da, db, dc
constexpr int OFF_A = 5;
constexpr int OFF_B = OFF_A + KSM;
constexpr int OFF_C = OFF_B + KSM;
constexpr int LEN_VAL = OFF_C + NTAIL;
constexpr int OFF_AP = LEN_VAL;
constexpr int OFF_BP = OFF_AP + KSM - 1;
constexpr int OFF_CP = OFF_BP + KSM - 1;
constexpr int LEN_DT = OFF_CP + NTAIL;
constexpr int OFF_DA = LEN_DT;
constexpr int OFF_DB = OFF_DA + KSM;
constexpr int OFF_DC = OFF_DB + KSM;
constexpr int LEN_DNU = OFF_DC + NTAIL;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// Copy the first `count` coefficients into the block's shared memory and,
// when the d/dt sets are present and the tail is truncated (nt < NTAIL),
// re-derive cp from the truncated c by the Chebyshev derivative recurrence.
// Every thread of the block calls it; the caller's next __syncthreads()
// publishes the result.
template <typename T>
__device__ __forceinline__ void stage(T* co, const T* __restrict__ src, int count, int nt) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) co[e] = src[e];
  if (count >= LEN_DT && nt < NTAIL) {
    __syncthreads();
    if (threadIdx.x == 0) {
      T up2 = T(0), up1 = T(0);  // cp[k + 1], cp[k]
      co[OFF_CP + nt - 1] = T(0);
      for (int k = nt - 1; k >= 1; --k) {
        const T v = up2 + T(2 * k) * co[OFF_C + k];  // cp[k - 1]
        co[OFF_CP + k - 1] = v;
        up2 = up1;
        up1 = v;
      }
      co[OFF_CP] *= T(0.5);
    }
  }
}

template <typename T>
__device__ __forceinline__ T horner(const T* c, int count, T w) {
  T acc = c[count - 1];
  for (int k = count - 2; k >= 0; --k) acc = acc * w + c[k];
  return acc;
}

template <typename T>
__device__ __forceinline__ T clenshaw(const T* c, int count, T s) {
  T b1 = T(0), b2 = T(0);
  for (int k = count - 1; k >= 1; --k) {
    const T b0 = c[k] + T(2) * s * b1 - b2;
    b2 = b1;
    b1 = b0;
  }
  return c[0] + s * b1 - b2;
}

// the kernels' expm1: a 4-term series under |z| < 1e-2, exp(z) - 1 above
template <typename T>
__device__ __forceinline__ T expm1_(T z) {
  if (fabs(z) < T(1e-2))
    return z * (T(1) + z * (T(0.5) + z * (T(1.0 / 6.0) + z * T(1.0 / 24.0))));
  return exp_(z) - T(1);
}

// phi, and where asked d phi/dt and the partial d phi/d nu at fixed t, from
// the staged coefficients `co`; `nt` tail terms.
template <typename T>
__device__ __forceinline__ void eval(T t, const T* co, int nt, bool need_dt,
                                     bool need_dnu, T& phi, T& dphi_dt, T& dphi_dnu) {
  dphi_dt = T(0);
  dphi_dnu = T(0);
  if (t <= T(0)) {
    phi = T(1);
    return;
  }
  if (t <= T(T0)) {
    const T nf = co[1], mu = co[2];
    const T w = T(0.25) * t * t;
    const T ws = w > T(1e-30) ? w : T(1e-30);
    const T L = log_(ws);
    const T Em = expm1_(mu * L);
    const T Wn = exp_(nf * L);  // w^n
    const T Q = horner(co + OFF_B, KSM, ws);
    phi = horner(co + OFF_A, KSM, ws) + Em * Wn * Q;
    const T X = Em + T(1);  // w^mu
    if (need_dt) {
      const T dP = horner(co + OFF_AP, KSM - 1, ws);
      const T dQ = horner(co + OFF_BP, KSM - 1, ws);
      // d/dw [P + Em w^n Q] = P' + w^n (Em Q' + mu X Q / w) + n w^{n-1} Em Q
      const T dphi_dw = dP + Wn * (Em * dQ + mu * X * Q / ws) + nf * (Wn / ws) * Em * Q;
      dphi_dt = dphi_dw * (T(0.5) * t);
    }
    if (need_dnu) {
      const T Pd = horner(co + OFF_DA, KSM, ws);
      const T Qd = horner(co + OFF_DB, KSM, ws);
      dphi_dnu = Pd + Wn * (Em * Qd + co[3] * (L * X * Q));
    }
    return;
  }
  const T tc = t < T(TMAX) ? t : T(TMAX);
  const T s = (tc - T(S_MID)) / T(S_HALF);
  phi = exp_(clenshaw(co + OFF_C, nt, s) - t);
  if (need_dt) {
    const T ds_dt = t > T(TMAX) ? T(0) : T(1.0 / S_HALF);
    dphi_dt = phi * (clenshaw(co + OFF_CP, nt, s) * ds_dt - T(1));
  }
  if (need_dnu) dphi_dnu = phi * clenshaw(co + OFF_DC, nt, s);
}

}  // namespace matern_nu
