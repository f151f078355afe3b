// The f64 CG continuation of the refined solve for one chain (the body of
// K4), shared by its own entry (cg_fallback.cu) and by the end of K3's block
// (solve_ru.cu), which calls it for a chain its f32 recursion left
// unconverged.
//
// Kept from schwingermodel_tpu/ops/pallas_df.py:_df_cg_fb_kernel, with the
// double-float state as native f64: entry certification of the x handed in;
// zero-restart when it is worse than x = 0; rounds chasing
// tgt = max(stop2/16, tau^2 rho_cert), each ending in a true residual that
// restarts the direction; the runaway guard rho > 1e6 ||b||^2; and the
// never-worse sanitizer against the entry state. Every decision reads only
// this chain's state.
//
// Per iteration: one f64 normal apply through the scratch (5 barriers) and
// two block sums of one barrier each.
#pragma once

#include "stencil.cuh"

namespace sm {

// f64 scratch values per half-lattice site beside the links: r, d, Ad, the
// entry x and two stencil temporaries (the third takes the first one's place)
constexpr int kFbScratch = 24;

struct FbOut {
  int iters;  // f64 CG iterations run
  int conv;   // the certified residual is below tol^2 ||b||^2
};

// Continues x (f64, n = 4 V2 values, read and written in place) and writes
// its f32 round to xo. ue, uo: the chain's f64 links, already built and
// visible to the block; w: kFbScratch * V2 doubles. The same result in
// every thread of the block.
__device__ inline FbOut cg_fallback_chain(const double* ue, const double* uo, const float* b,
                                          double* x, float* xo, double* w, double m0, double tol,
                                          double tau, int max_iter, int max_rounds, const Geo& g,
                                          BlockSum& sum) {
  const int V2 = g.V2, n = 4 * V2;
  double *r = w, *d = w + 4 * V2, *Ad = w + 8 * V2, *xe = w + 12 * V2;
  double *t1 = w + 16 * V2, *t2 = w + 20 * V2;
  const double m = m0 + 2.0, c = 1.0 / (4.0 * (m0 + 2.0));
  const double bnorm2 = sum.dot(b, b, n);
  const double stop2 = tol * tol * bnorm2;
  const double tau2 = tau * tau;

  auto true_residual = [&]() -> double {
    normal_apply<double>(ue, uo, x, Ad, t1, t2, t1, m, c, g);
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const double ri = static_cast<double>(b[i]) - Ad[i];
      r[i] = ri;
      acc += ri * ri;
    }
    return sum(acc);
  };

  // entry certification; zero-restart a start worse than x = 0
  double rho = true_residual();
  if (rho > bnorm2) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      x[i] = 0.0;
      r[i] = b[i];
    }
    rho = bnorm2;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
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
      normal_apply<double>(ue, uo, d, Ad, t1, t2, t1, m, c, g);
      const double dAd = sum.dot(d, Ad, n);
      const double alpha = rho / dAd;
      ++k_tot;
      if (!(dAd > 0.0) || !isfinite(alpha)) {
        dead = true;
        break;
      }
      double acc = 0.0;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        x[i] += alpha * d[i];
        const double ri = r[i] - alpha * Ad[i];
        r[i] = ri;
        acc += ri * ri;
      }
      const double rho_c = sum(acc);
      if (!isfinite(rho_c) || rho_c > 1e6 * bnorm2) {
        dead = true;
        break;
      }
      const double beta = rho_c / rho;
      for (int i = threadIdx.x; i < n; i += kThreads) d[i] = r[i] + beta * d[i];
      rho = rho_c;
      ++iters;
    }
    // re-certify with the true residual and restart the direction on it
    rho = true_residual();
    if (!dead)
      for (int i = threadIdx.x; i < n; i += kThreads) d[i] = r[i];
    rho_prev = rho_cert;
    rho_cert = rho;
    ++ko;
  }

  // never return worse than the entry state
  const bool better = rho_cert < rho_entry;
  if (!better) rho_cert = rho_entry;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!better) x[i] = xe[i];
    xo[i] = static_cast<float>(x[i]);
  }
  return {iters, rho_cert < stop2 ? 1 : 0};
}

}  // namespace sm
