// K4: f64 CG continuation of the refined solve (the conditioning fallback).
//
// Replaces schwingermodel_tpu/ops/pallas_df.py:_df_cg_fb_kernel
// (solve_df_cg_fused, behind the lax.cond of solve_refined_fused). The
// double-float vector state becomes native f64: x, r, d and Ad are f64, so
// the attainable residual is the f64 floor ~kappa * eps_f64, where the f32
// recursion of K3 stagnates near kappa * eps_f32. Kept from the TPU kernel:
// entry certification of K3's x; zero-restart when it is worse than x = 0;
// rounds chasing tgt = max(stop2/16, tau^2 rho_cert), each ending in a true
// residual that restarts the direction; the runaway guard
// rho > 1e6 ||b||^2; and the never-worse sanitizer against the entry state.
//
// The wrapper launches it after every K3 call without reading K3's flags on
// the host: each block reads its chain's flag from device memory, and a
// chain that K3 converged copies its result through and exits at once. So
// the common all-converged case costs one short launch and no host
// synchronisation. Semantics are per chain, as in K3.
//
// What bounds it on the card: as K3, barrier and L2 latency per iteration
// (f64 stencil arithmetic runs at half the f32 rate, which is not the
// limit at 2048 sites per chain). One thread block per chain, vectors in a
// per-chain global scratch of about 0.6 MB at 64x64.
#include "stencil.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
cg_fallback_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                   const float* __restrict__ b_all, const double* __restrict__ x_in_all,
                   const int* __restrict__ conv_in, const int* __restrict__ iters_in,
                   float* __restrict__ x_all, double* __restrict__ x64_all,
                   int* __restrict__ iters_out, int* __restrict__ conv_out,
                   double* __restrict__ s64_all, int Nx, int Nth, double m0, double tol,
                   double tau, int max_iter, int max_rounds) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2, n = 4 * V2;
  const int ch = blockIdx.x;
  const double* x_in = x_in_all + (size_t)ch * n;
  float* xo = x_all + (size_t)ch * n;
  double* x = x64_all + (size_t)ch * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = x_in[i];

  if (conv_in[ch]) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) xo[i] = static_cast<float>(x_in[i]);
    if (threadIdx.x == 0) {
      iters_out[ch] = iters_in[ch];
      conv_out[ch] = 1;
    }
    return;
  }

  const float* the = thE + (size_t)ch * 2 * V2;
  const float* tho = thO + (size_t)ch * 2 * V2;
  const float* b = b_all + (size_t)ch * n;
  double* s64 = s64_all + (size_t)ch * 36 * V2;
  double *ue = s64, *uo = s64 + 4 * V2, *r = s64 + 8 * V2, *d = s64 + 12 * V2;
  double *Ad = s64 + 16 * V2, *xe = s64 + 20 * V2;
  double *t1 = s64 + 24 * V2, *t2 = s64 + 28 * V2, *t3 = s64 + 32 * V2;
  const double m = m0 + 2.0, c = 1.0 / (4.0 * (m0 + 2.0));

  make_links<double>(the, 0, ue, g);
  make_links<double>(tho, 1, uo, g);
  const double bnorm2 = block_dot(b, b, n, sh);
  const double stop2 = tol * tol * bnorm2;
  const double tau2 = tau * tau;

  auto true_residual = [&]() -> double {
    normal_apply<double>(ue, uo, x, Ad, t1, t2, t3, m, c, g);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      r[i] = static_cast<double>(b[i]) - Ad[i];
    return block_dot(r, r, n, sh);
  };

  // entry certification; zero-restart a start worse than x = 0
  double rho = true_residual();
  if (rho > bnorm2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      x[i] = 0.0;
      r[i] = b[i];
    }
    rho = bnorm2;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xe[i] = x[i];
    d[i] = r[i];
  }
  const double rho_entry = rho;

  double rho_cert = rho, rho_prev = INFINITY;
  bool dead = false;
  int iters = 0, k_tot = 0, ko = 0;
  while (rho_cert >= stop2 && !dead && (ko == 0 || rho_cert * 4.0 <= rho_prev) &&
         k_tot < max_iter && ko < max_rounds) {
    const double tgt = fmax(stop2 * 0.0625, tau2 * rho_cert);
    while (!dead && rho >= tgt && k_tot < max_iter) {
      normal_apply<double>(ue, uo, d, Ad, t1, t2, t3, m, c, g);
      const double dAd = block_dot(d, Ad, n, sh);
      const double alpha = rho / dAd;
      ++k_tot;
      if (!(dAd > 0.0) || !isfinite(alpha)) {
        dead = true;
        break;
      }
      double acc = 0.0;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        x[i] += alpha * d[i];
        const double ri = r[i] - alpha * Ad[i];
        r[i] = ri;
        acc += ri * ri;
      }
      const double rho_c = block_sum(acc, sh);
      if (!isfinite(rho_c) || rho_c > 1e6 * bnorm2) {
        dead = true;
        break;
      }
      const double beta = rho_c / rho;
      for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = r[i] + beta * d[i];
      rho = rho_c;
      ++iters;
    }
    // re-certify with the true residual and restart the direction on it
    rho = true_residual();
    if (!dead)
      for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = r[i];
    rho_prev = rho_cert;
    rho_cert = rho;
    ++ko;
  }

  // never return worse than the entry state
  const bool better = rho_cert < rho_entry;
  if (!better) rho_cert = rho_entry;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!better) x[i] = xe[i];
    xo[i] = static_cast<float>(x[i]);
  }
  if (threadIdx.x == 0) {
    iters_out[ch] = iters_in[ch] + iters;
    conv_out[ch] = rho_cert < stop2 ? 1 : 0;
  }
}

}  // namespace sm

extern "C" int cg_fallback_launch(const void* thE, const void* thO, const void* b,
                                  const void* x64_in, const void* conv_in, const void* iters_in,
                                  void* x, void* x64, void* iters, void* conv, void* s64, int C,
                                  int Nx, int Nth, double m0, double tol, double tau,
                                  int max_iter, int max_rounds, void* stream) {
  sm::cg_fallback_kernel<<<C, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thE), static_cast<const float*>(thO),
      static_cast<const float*>(b), static_cast<const double*>(x64_in),
      static_cast<const int*>(conv_in), static_cast<const int*>(iters_in),
      static_cast<float*>(x), static_cast<double*>(x64), static_cast<int*>(iters),
      static_cast<int*>(conv), static_cast<double*>(s64), Nx, Nth, m0, tol, tau, max_iter,
      max_rounds);
  return static_cast<int>(cudaGetLastError());
}
