// K4's coefficient constructor: the traced-smoothness Matern's coefficient
// vector built from nu in one launch, hand-written for Hopper.
//
// Replaces muygpys_tpu/pallas/matern_nu.py:_build_value_coeffs and
// matern_nu_coeffs (one jitted XLA program there; ~12,000 small launches of
// plain tensor code in muygpys_torch/gpu/matern_nu.py:matern_nu_coeffs_plain,
// whose kve is muygpys_torch/ops/bessel.py:_kve_raw, all under
// torch.func.jvp).  From a one-element nu on the card it writes the flat
// vector of matern_nu.cuh's layout, in the dtype of nu:
//   [sqrt(2 nu), n, mu, 1, 1/(2 nu)], a (KSM), q (KSM), c (NTAIL)  LEN_VAL
//   ap (KSM-1), bp (KSM-1), cp (NTAIL)                             LEN_DT
//   da, dq, dc: the nu-tangents of a, q, c (need_dnu)              LEN_DNU
// and, where asked, the nu-tangent of the whole LEN_DT vector (the autograd
// Function's backward).  nu never leaves the card.
//
// Every quantity is a dual number (value, d/dnu) carried through the plain
// version's operations in its order, each tangent by the forward-mode rule
// PyTorch applies to that operation (a / b: (da - db r) / b; c / b as
// PyTorch computes it, reciprocal(b) c; cumprod: r cumsum(dx / x);
// lgamma: digamma), so the result is what torch.func.jvp gives through the
// plain version, with no finite differences.  The source is compiled
// without contraction into fused multiply-adds (gpu/_build.py): near an
// integer nu the coefficients a_k = u_k + q_{k-n} are differences of terms
// ~1/|mu| (their tangents ~1/mu^2), which amplify any change of rounding.
//
// The clamp is gradient-transparent as in the plain version: mu is moved to
// +-MU_CLAMP (1e-2 in f32, 1e-7 in f64) by an offset without a tangent, so
// d mu_eff / d nu = 1 everywhere.
//
// What bounds it on an H100: neither bytes (~7 KB of constants in, < 2 KB
// out) nor operations (~10^5): the latency of one dependent chain, the up
// to 80 steps of Steed's CF2 continued fraction with two divides a step,
// then a 40-term dot product and a 40-step recurrence.  The design keeps
// that chain single: one block of 96 threads.
//   warps 0-1, threads 0..NTAIL-1: node k of the tail's Chebyshev fit,
//     g_k = log_pref + nu ln t_k + ln kve(nu, t_k) and its tangent, kve by
//     CF2 (every node lies above T0 = 2, where the plain version selects
//     CF2; its Temme branch is computed there only to be discarded) and the
//     upward recurrence in the order;
//   warp 2, threads 64..64+KSM-1: series index j, u_j by its running
//     product and q_j through lgamma;
//   one barrier, then c = CHEB_MAT g (thread k a row), a = u + shifted q,
//   ap, bp and the scalars; one more barrier, then cp (and its tangent) by
//   the Chebyshev derivative recurrence on one thread each.
// The constants (the Chebyshev-Gauss nodes, CHEB_MAT, k!, ln k!) come from
// the same f64 numpy arrays as the plain version's, cast to the dtype on
// the host, so their bits are the plain version's.

#include <cuda_runtime.h>

#include "matern_nu.cuh"

namespace {

using matern_nu::KSM;
using matern_nu::NTAIL;

constexpr int kThreads = 96;
constexpr int kSeriesThread0 = 64;
// the constants' layout: nodes t_k, k!, ln k!, then CHEB_MAT row-major
constexpr int C_NODES = 0;
constexpr int C_FACT = C_NODES + NTAIL;
constexpr int C_LOGFACT = C_FACT + KSM;
constexpr int C_CHEB = C_LOGFACT + KSM;
constexpr int C_LEN = C_CHEB + NTAIL * NTAIL;
constexpr int CF2_ITERS = 80;  // muygpys_torch/ops/bessel.py:_CF2_ITERS
constexpr int RECUR_MAX = 64;  // muygpys_torch/ops/bessel.py:_RECUR_MAX
constexpr double kPi = 3.141592653589793;
constexpr double kLn2 = 0.6931471805599453;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }
__device__ __forceinline__ float lgamma_t(float x) { return lgammaf(x); }
__device__ __forceinline__ double lgamma_t(double x) { return lgamma(x); }
__device__ __forceinline__ float tan_t(float x) { return tanf(x); }
__device__ __forceinline__ double tan_t(double x) { return tan(x); }

// digamma, the tangent of lgamma (CUDA's math library has none): the
// recurrence psi(x) = psi(x + 1) - 1/x up to x >= 10, then the asymptotic
// series ln x - 1/(2x) - sum_k B_2k / (2k x^2k) to x^-14 (the next term is
// below 5e-17 at x = 10); the reflection psi(x) = psi(1 - x) - pi / tan(pi x)
// below 0.  The operations of ATen's CPU digamma, in its order.
template <typename T>
__device__ T digamma(T x) {
  if (x == T(0)) return T(1) / x > T(0) ? -T(INFINITY) : T(INFINITY);  // -+inf at +-0
  T result = T(0);
  if (x < T(0)) {
    if (x == floor_t(x)) return T(NAN);
    const T r = x - (x < T(0) ? -floor_t(-x) : floor_t(x));  // the fraction, as modf
    result = -T(kPi) / tan_t(T(kPi) * r);
    x = T(1) - x;
  }
  while (x < T(10)) {
    result -= T(1) / x;
    x += T(1);
  }
  if (x == T(10)) return result + T(2.25175258906672110764);
  const T A[] = {T(8.33333333333333333333E-2), T(-2.10927960927960927961E-2),
                 T(7.57575757575757575758E-3), T(-4.16666666666666666667E-3),
                 T(3.96825396825396825397E-3), T(-8.33333333333333333333E-3),
                 T(8.33333333333333333333E-2)};
  T y = T(0);
  if (x < T(1.0e17)) {
    const T z = T(1) / (x * x);
    T p = A[0];
    for (int i = 1; i <= 6; ++i) p = p * z + A[i];
    y = z * p;
  }
  return result + log_t(x) - T(0.5) / x - y;
}

// a dual number: value and d/dnu
template <typename T>
struct Dual {
  T v, d;
};
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + b.d * a.v};
}
// a dual times, or over, a constant (a tensor or number without a tangent)
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T c) { return {a.v * c, a.d * c}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) { return {a.v / c, a.d / c}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T r = a.v / b.v;
  return {r, (a.d - b.d * r) / b.v};
}
// c / b for a constant c, as PyTorch computes a number over a tensor:
// reciprocal(b) * c
template <typename T>
__device__ __forceinline__ Dual<T> rdiv(T c, Dual<T> b) {
  const T r = T(1) / b.v;
  return {r * c, (-b.d * (r * r)) * c};
}
// a constant tensor c over a dual b (tensor division, c without a tangent)
template <typename T>
__device__ __forceinline__ Dual<T> cdiv(T c, Dual<T> b) {
  const T r = c / b.v;
  return {r, (T(0) - b.d * r) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> exp_d(Dual<T> a) {
  const T e = exp_t(a.v);
  return {e, a.d * e};
}
template <typename T>
__device__ __forceinline__ Dual<T> log_d(Dual<T> a) { return {log_t(a.v), a.d / a.v}; }
template <typename T>
__device__ __forceinline__ Dual<T> sqrt_d(Dual<T> a) {
  const T r = sqrt_t(a.v);
  return {r, a.d / (T(2) * r)};
}
template <typename T>
__device__ __forceinline__ Dual<T> lgamma_d(Dual<T> a) {
  return {lgamma_t(a.v), a.d * digamma(a.v)};
}

// exp(x) (K_mu(x), K_{mu+1}(x)) by Steed's CF2 for x > 2, with the plain
// version's freeze: an element stops, value and tangent, once its fraction
// has converged (|delh| <= 0.01 eps |h|) or its auxiliaries near overflow
// (max(|u|, |w|) > 1e-8 x the dtype's largest): the guard is what ends f32
// at large x.  The stop is tested on the values, in the dtype.
template <typename T>
__device__ void kve_cf2(Dual<T> mu, T x, Dual<T>& kmu, Dual<T>& kmu1) {
  const T eps = sizeof(T) == 4 ? T(1.1920928955078125e-07 * 0.01) : T(2.220446049250313e-16 * 0.01);
  const T big = sizeof(T) == 4 ? T(3.4028234663852886e+38 * 1e-8) : T(1.7976931348623157e+308 * 1e-8);
  const Dual<T> zero = {T(0), T(0)};
  T b = T(2) * (T(1) + x);
  Dual<T> d = {T(1) / b * T(1), T(0)};
  Dual<T> h = d, delh = d;
  const Dual<T> a1 = Dual<T>{T(0.25), T(0)} - mu * mu;
  Dual<T> q = a1, a = -a1, s = Dual<T>{T(1), T(0)} + q * delh;
  Dual<T> u = zero, w = a1;
  bool done = false;
  for (int i = 2; i <= CF2_ITERS && !done; ++i) {
    const T fi = T(i);
    const Dual<T> a_n = a - Dual<T>{T(2) * (fi - T(1)), T(0)};
    const Dual<T> contrib = (-(u - w * b)) / fi;
    const Dual<T> q_n = q + contrib;
    const Dual<T> u_n = ((-a_n) * w) / fi;
    const T b_n = b + T(2);
    const Dual<T> den = Dual<T>{b_n, T(0)} + a_n * d;
    const Dual<T> d_n = rdiv(T(1), den);
    const Dual<T> delh_n = (d_n * b_n - Dual<T>{T(1), T(0)}) * delh;
    const Dual<T> h_n = h + delh_n;
    const Dual<T> s_n = s + q_n * delh_n;
    a = a_n, b = b_n, d = d_n, h = h_n, delh = delh_n, q = q_n, u = u_n, w = contrib, s = s_n;
    done = fabs(delh_n.v) <= eps * fabs(h_n.v) || fmax(fabs(u_n.v), fabs(contrib.v)) > big;
  }
  h = a1 * h;
  const T root = sqrt_t(T(1) / (T(2) * x) * T(kPi));
  kmu = cdiv(root, s);
  kmu1 = ((kmu * (((mu + Dual<T>{x, T(0)}) + Dual<T>{T(0.5), T(0)}) - h)) / x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) matern_nu_coeffs_kernel(
    const T* __restrict__ nu_in,   // (1,)
    const T* __restrict__ consts,  // (C_LEN,): nodes, k!, ln k!, CHEB_MAT
    T* __restrict__ out,           // (LEN_VAL+...): LEN_DT, or LEN_DNU with need_dnu
    T* __restrict__ dout,          // (LEN_DT,) the tangent of out[:LEN_DT], or null
    int need_dnu) {
  using namespace matern_nu;
  __shared__ Dual<T> g[NTAIL], c[NTAIL], u[KSM], q[KSM];
  const int tid = threadIdx.x;

  // the gradient-transparent clamp (matern_nu.py:_clamp_offset): the offset
  // is formed from the value alone
  const T nu = nu_in[0];
  const T clamp = sizeof(T) == 4 ? T(1e-2) : T(1e-7);
  const T n = floor_t(nu + T(0.5));
  const T mu0 = nu - n;
  const T delta = fabs(mu0) < clamp ? (mu0 >= T(0) ? T(1) : T(-1)) * clamp - mu0 : T(0);
  const Dual<T> mu_eff = Dual<T>{mu0, T(1)} + Dual<T>{delta, T(0)};
  const Dual<T> nu_eff = Dual<T>{n, T(0)} + mu_eff;
  const Dual<T> lg_nu = lgamma_d(nu_eff);

  if (tid < NTAIL) {
    // node k: g = log_pref + nu ln t + ln kve(nu, t)
    const T t = consts[C_NODES + tid];
    const Dual<T> log_pref = (Dual<T>{T(1), T(0)} - nu_eff) * T(kLn2) - lg_nu;
    // kve re-derives the order's split from nu_eff, as _kve_raw does
    const Dual<T> v = {fabs(nu_eff.v), nu_eff.v >= T(0) ? nu_eff.d : -nu_eff.d};
    const T nv = floor_t(v.v + T(0.5));
    const Dual<T> mu = v - Dual<T>{nv, T(0)};
    Dual<T> kprev, kcur;
    kve_cf2(mu, t, kprev, kcur);
    for (int i = 1; i < RECUR_MAX && T(i) <= nv - T(1); ++i) {
      const Dual<T> coef = ((mu + Dual<T>{T(i), T(0)}) * T(2)) / t;
      const Dual<T> knext = kprev + coef * kcur;
      kprev = kcur;
      kcur = knext;
    }
    const Dual<T> kv = nv == T(0) ? kprev : kcur;
    const Dual<T> lt = {log_t(t), T(0)};
    g[tid] = (log_pref + nu_eff * lt) + log_d(kv);
  } else if (tid >= kSeriesThread0 && tid < kSeriesThread0 + KSM) {
    const int j = tid - kSeriesThread0;
    // u_j = (-1)^j / (j! prod_{i=1..j} (mu + (n - i)))
    Dual<T> uj = {T(1), T(0)};
    if (j > 0) {
      // cumprod and its tangent r cumsum(dx / x), as PyTorch forms it
      T p = T(1), sum = T(0);
      for (int i = 1; i <= j; ++i) {
        const T x = mu_eff.v + (n - T(i));
        p = p * x;
        sum = sum + T(1) / x;
      }
      const Dual<T> prod = {p, sum * p};
      uj = cdiv(j % 2 ? T(-1) : T(1), prod * consts[C_FACT + j]);
    }
    u[j] = uj;
    // q_j = -pi / (sin(pi nu) Gamma(nu) j! Gamma(j+1+nu)), sin(pi nu) as
    // (-1)^n sin(pi mu)
    const Dual<T> log_mag = (-lg_nu - lgamma_d(Dual<T>{T(j) + T(1), T(0)} + nu_eff)) -
                            Dual<T>{consts[C_LOGFACT + j], T(0)};
    const T rem = n - T(2) * floor_t(n / T(2));
    const Dual<T> pimu = mu_eff * T(kPi);
    const Dual<T> sin_pinu = Dual<T>{sin_t(pimu.v), pimu.d * cos_t(pimu.v)} * (T(1) - T(2) * rem);
    q[j] = (-rdiv(T(kPi), sin_pinu)) * exp_d(log_mag);
  }
  __syncthreads();

  if (tid < NTAIL) {
    // c = CHEB_MAT g, the tangent CHEB_MAT dg
    const T* row = consts + C_CHEB + tid * NTAIL;
    T cv = T(0), cd = T(0);
    for (int k = 0; k < NTAIL; ++k) {
      cv = cv + row[k] * g[k].v;
      cd = cd + row[k] * g[k].d;
    }
    c[tid] = {cv, cd};
    out[OFF_C + tid] = cv;
    if (need_dnu) out[OFF_DC + tid] = cd;
    if (dout) dout[OFF_C + tid] = cd;
  } else if (tid >= kSeriesThread0 && tid < kSeriesThread0 + KSM) {
    // a_k = u_k + q_{k-n} for k >= n; ap = k a_k, bp = k q_k
    const int k = tid - kSeriesThread0;
    const int ni = (int)n;
    Dual<T> ak = u[k];
    if (k >= ni) {
      const int src = k - ni < KSM - 1 ? k - ni : KSM - 1;
      ak = ak + q[src > 0 ? src : 0];
    }
    out[OFF_A + k] = ak.v;
    out[OFF_B + k] = q[k].v;
    if (need_dnu) {
      out[OFF_DA + k] = ak.d;
      out[OFF_DB + k] = q[k].d;
    }
    if (dout) {
      dout[OFF_A + k] = ak.d;
      dout[OFF_B + k] = q[k].d;
    }
    if (k >= 1) {
      out[OFF_AP + k - 1] = T(k) * ak.v;
      out[OFF_BP + k - 1] = T(k) * q[k].v;
      if (dout) {
        dout[OFF_AP + k - 1] = ak.d * T(k);
        dout[OFF_BP + k - 1] = q[k].d * T(k);
      }
    }
  } else if (tid == kSeriesThread0 + KSM) {
    // [sqrt(2 nu), n, mu, gate, 1/(2 nu)]
    const Dual<T> root = sqrt_d(nu_eff * T(2));
    const Dual<T> half_inv = rdiv(T(0.5), nu_eff);
    out[0] = root.v, out[1] = n, out[2] = mu_eff.v, out[3] = T(1), out[4] = half_inv.v;
    if (dout) dout[0] = root.d, dout[1] = T(0), dout[2] = mu_eff.d, dout[3] = T(0), dout[4] = half_inv.d;
  }
  __syncthreads();

  // cp: the d/ds coefficients of the tail, d[k-1] = d[k+1] + 2k c[k],
  // d[0] halved (matern_nu.py:_cheb_deriv_coeffs); thread 32 the tangent
  if (tid == 0 || (tid == 32 && dout)) {
    const bool tangent = tid == 32;
    T* dst = (tangent ? dout : out) + OFF_CP;
    T up2 = T(0), up1 = T(0);  // d[k + 1], d[k]
    dst[NTAIL - 1] = T(0);
    for (int k = NTAIL - 1; k >= 1; --k) {
      const T v = up2 + T(2 * k) * (tangent ? c[k].d : c[k].v);
      dst[k - 1] = v;
      up2 = up1;
      up1 = v;
    }
    dst[0] = T(0.5) * dst[0];
  }
}

// digamma alone, elementwise: the check of the device function against
// torch.special.digamma (tests/test_torch_cuda.py, the CPU emulation)
template <typename T>
__global__ void digamma_kernel(const T* __restrict__ x, T* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = digamma(x[i]);
}

template <typename T>
int launch_digamma(const T* x, T* out, int count, void* stream) {
  if (count == 0) return 0;
  digamma_kernel<T><<<(count + 127) / 128, 128, 0, (cudaStream_t)stream>>>(x, out, count);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* nu, const T* consts, T* out, T* dout, int need_dnu, void* stream) {
  matern_nu_coeffs_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(nu, consts, out, dout,
                                                                        need_dnu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matern_nu_coeffs_f32(const float* nu, const float* consts, float* out, float* dout,
                         int need_dnu, void* stream) {
  return launch<float>(nu, consts, out, dout, need_dnu, stream);
}

int matern_nu_coeffs_f64(const double* nu, const double* consts, double* out, double* dout,
                         int need_dnu, void* stream) {
  return launch<double>(nu, consts, out, dout, need_dnu, stream);
}

int matern_nu_coeffs_constants_length() { return C_LEN; }

int matern_nu_digamma_f32(const float* x, float* out, int count, void* stream) {
  return launch_digamma<float>(x, out, count, stream);
}

int matern_nu_digamma_f64(const double* x, double* out, int count, void* stream) {
  return launch_digamma<double>(x, out, count, stream);
}

const char* muygpys_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
