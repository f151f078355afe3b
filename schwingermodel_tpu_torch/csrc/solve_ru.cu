// K3: reliable-update mixed-precision CG on (Dhat Dhat^+) x = b.
//
// Replaces schwingermodel_tpu/ops/pallas_df.py:_solve_ru_kernel
// (solve_refined_fused, K = 1 history). The algorithm is kept and the
// double-float half becomes native f64: one continuous f32 CG recursion;
// x accumulated in f64 as x += (double)alpha * (double)d; each time the
// recursive residual has contracted by tau it is replaced by the true
// residual b - A x evaluated in f64 (links from sincos((double)theta)) and
// rounded to f32. certify=false trusts the recursive exit for segments
// shorter than cert_k iterations. Semantics are per chain: every decision
// (inner target, replacement gate, stagnation test, iteration cap) reads
// only that chain's state -- the reference's one-CG-per-chain semantics.
// The MRE start (history depth >= 2) is not ported.
//
// What bounds it on the card: per iteration one normal apply (4 dependent
// stencil stages of ~150 flops per site) and 2 block reductions on 2048
// sites per chain at 64x64, i.e. latency of barriers and L2 round trips, not
// bandwidth or flops. Design: one thread block per chain runs the whole
// solve loop, so no host synchronisation or relaunch happens per iteration;
// all vectors (f32 and f64 links, r, d, Ad, stencil temporaries, x in f64)
// live in a per-chain global scratch of about 0.6 MB that stays in L2.
// Dots are block reductions accumulated in f64 and rounded to f32.
#include "stencil.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
solve_ru_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                const float* __restrict__ b_all, const float* __restrict__ x0_all,
                float* __restrict__ x_all, double* __restrict__ x64_all, int* __restrict__ iters_out,
                int* __restrict__ conv_out, float* __restrict__ s32_all,
                double* __restrict__ s64_all, int Nx, int Nth, double m0, double tol,
                double tau, int max_iter, int max_outer, int certify, int cert_k) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2, n = 4 * V2;
  const int ch = blockIdx.x;
  const float* the = thE + (size_t)ch * 2 * V2;
  const float* tho = thO + (size_t)ch * 2 * V2;
  const float* b = b_all + (size_t)ch * n;
  const float* x0 = x0_all + (size_t)ch * n;
  float* xo = x_all + (size_t)ch * n;
  double* x = x64_all + (size_t)ch * n;
  float* s32 = s32_all + (size_t)ch * 32 * V2;
  float *ue = s32, *uo = s32 + 4 * V2, *r = s32 + 8 * V2, *d = s32 + 12 * V2;
  float *Ad = s32 + 16 * V2, *t1 = s32 + 20 * V2, *t2 = s32 + 24 * V2, *t3 = s32 + 28 * V2;
  double* s64 = s64_all + (size_t)ch * 24 * V2;
  double *ue64 = s64, *uo64 = s64 + 4 * V2, *Ax = s64 + 8 * V2;
  double *u1 = s64 + 12 * V2, *u2 = s64 + 16 * V2, *u3 = s64 + 20 * V2;

  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const double m64 = m0 + 2.0, c64 = 1.0 / (4.0 * (m0 + 2.0));

  make_links<float>(the, 0, ue, g);
  make_links<float>(tho, 1, uo, g);
  make_links<double>(the, 0, ue64, g);
  make_links<double>(tho, 1, uo64, g);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = static_cast<double>(x0[i]);

  const float bnorm2 = static_cast<float>(block_dot(b, b, n, sh));
  const float stop2 = static_cast<float>(tol * tol) * bnorm2;
  const float tau2 = static_cast<float>(tau * tau);

  // r = f32(b - A x) in f64; returns rho = <r, r>
  auto true_residual = [&]() -> float {
    normal_apply<double>(ue64, uo64, x, Ax, u1, u2, u3, m64, c64, g);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      r[i] = static_cast<float>(static_cast<double>(b[i]) - Ax[i]);
    return static_cast<float>(block_dot(r, r, n, sh));
  };

  float rho = true_residual();
  // forecast sanitizer: a start worse than x = 0 restarts from x = 0,
  // whose residual is b exactly
  if (rho > bnorm2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      x[i] = 0.0;
      r[i] = b[i];
    }
    rho = bnorm2;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = r[i];

  float rho_df = rho, rho_df_prev = INFINITY;
  int iters = 0, k_tot = 0, k_rep = 0, ko = 0;
  while (rho_df >= stop2 && ko < max_outer && (ko == 0 || rho_df * 4.0f <= rho_df_prev) &&
         k_tot < max_iter) {
    // chase tau^2 below the certified residual, or the final target
    const float tgt = fmaxf(stop2, tau2 * rho_df);
    bool dead = false;
    while (!dead && rho >= tgt && k_tot < max_iter) {
      normal_apply<float>(ue, uo, d, Ad, t1, t2, t3, m, c, g);
      const float dAd = static_cast<float>(block_dot(d, Ad, n, sh));
      const float alpha = rho / dAd;
      ++k_tot;
      // breakdown: non-positive curvature or alpha overflow freezes the
      // chain before its state is touched
      if (!(dAd > 0.0f) || !isfinite(alpha)) {
        dead = true;
        break;
      }
      double acc = 0.0;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        x[i] += static_cast<double>(alpha) * static_cast<double>(d[i]);
        const float ri = r[i] + (-alpha) * Ad[i];
        r[i] = ri;
        acc += static_cast<double>(ri) * static_cast<double>(ri);
      }
      const float rho_c = static_cast<float>(block_sum(acc, sh));
      // overflow or runaway divergence: freeze with x and r as updated
      if (!isfinite(rho_c) || rho_c > 1e6f * bnorm2) {
        dead = true;
        break;
      }
      const float beta = rho_c / rho;
      for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = r[i] + beta * d[i];
      rho = rho_c;
      ++iters;
    }
    // reliable update: always when certifying, otherwise only for a
    // multi-phase contraction or a segment of cert_k iterations or more
    if (certify || tgt > stop2 || k_tot - k_rep >= cert_k) {
      rho = true_residual();
      k_rep = k_tot;
    }
    rho_df_prev = rho_df;
    rho_df = rho;
    ++ko;
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) xo[i] = static_cast<float>(x[i]);
  if (threadIdx.x == 0) {
    iters_out[ch] = iters;
    conv_out[ch] = rho_df < stop2 ? 1 : 0;
  }
}

}  // namespace sm

extern "C" int solve_ru_launch(const void* thE, const void* thO, const void* b, const void* x0,
                               void* x, void* x64, void* iters, void* conv, void* s32, void* s64,
                               int C, int Nx, int Nth, double m0, double tol, double tau,
                               int max_iter, int max_outer, int certify, int cert_k,
                               void* stream) {
  sm::solve_ru_kernel<<<C, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thE), static_cast<const float*>(thO),
      static_cast<const float*>(b), static_cast<const float*>(x0), static_cast<float*>(x),
      static_cast<double*>(x64), static_cast<int*>(iters), static_cast<int*>(conv),
      static_cast<float*>(s32), static_cast<double*>(s64), Nx, Nth, m0, tol, tau, max_iter,
      max_outer, certify, cert_k);
  return static_cast<int>(cudaGetLastError());
}
