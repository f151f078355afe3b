// K4: f64 CG continuation of the refined solve (the conditioning fallback),
// as an entry of its own.
//
// Replaces schwingermodel_tpu/ops/pallas_df.py:_df_cg_fb_kernel
// (solve_df_cg_fused, behind the lax.cond of solve_refined_fused). The
// double-float vector state becomes native f64: x, r, d and Ad are f64, so
// the attainable residual is the f64 floor ~kappa * eps_f64, where the f32
// recursion of K3 stagnates near kappa * eps_f32. The body is
// cg_fallback_chain (cg_fallback.cuh), which K3 also calls at the end of its
// own block: the packed trajectory reaches the fallback through K3's launch
// and never through this one. This entry serves the restart refinement of
// the measurement solves (solvers/refine.py), whose first stage is not K3.
//
// Each block reads its chain's flag from device memory, and a chain that
// arrives converged copies its x through and exits at once, so the caller
// needs no host synchronisation to decide. Semantics are per chain.
//
// What bounds it on the card: barrier and L2 latency per iteration (f64
// stencil arithmetic runs at half the f32 rate, which is not the limit at
// 2048 sites per chain): 7 barriers an iteration, 5 of them followed by
// neighbour reads from L2. One thread block per chain, vectors in a
// per-chain global scratch of 32 V2 doubles, 0.5 MB at 64x64.
#include "cg_fallback.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
cg_fallback_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                   const float* __restrict__ b_all, const double* __restrict__ x_in_all,
                   const unsigned char* __restrict__ conv_in, const int* __restrict__ iters_in,
                   float* __restrict__ x_all, double* __restrict__ x64_all,
                   int* __restrict__ iters_out, int* __restrict__ fb_iters_out,
                   unsigned char* __restrict__ conv_out, double* __restrict__ s64_all, int Nx,
                   int Nth, double m0, double tol, double tau, int max_iter, int max_rounds) {
  __shared__ double sh[2 * (kThreads / 32)];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2, n = 4 * V2;
  const int ch = blockIdx.x;
  const double* x_in = x_in_all + (size_t)ch * n;
  float* xo = x_all + (size_t)ch * n;
  double* x = x64_all + (size_t)ch * n;
  for (int i = threadIdx.x; i < n; i += kThreads) x[i] = x_in[i];

  if (conv_in[ch]) {
    for (int i = threadIdx.x; i < n; i += kThreads) xo[i] = static_cast<float>(x_in[i]);
    if (threadIdx.x == 0) {
      iters_out[ch] = iters_in[ch];
      fb_iters_out[ch] = 0;
      conv_out[ch] = 1;
    }
    return;
  }

  double* s64 = s64_all + (size_t)ch * (8 + kFbScratch) * V2;
  double *ue = s64, *uo = s64 + 4 * V2;
  make_links<double>(thE + (size_t)ch * 2 * V2, 0, ue, g);
  make_links<double>(thO + (size_t)ch * 2 * V2, 1, uo, g);
  BlockSum sum{sh, 0};
  const FbOut fb = cg_fallback_chain(ue, uo, b_all + (size_t)ch * n, x, xo, s64 + 8 * V2, m0,
                                     tol, tau, max_iter, max_rounds, g, sum);
  if (threadIdx.x == 0) {
    iters_out[ch] = iters_in[ch] + fb.iters;
    fb_iters_out[ch] = fb.iters;
    conv_out[ch] = fb.conv;
  }
}

}  // namespace sm

// thE, thO: f32 [C, 2, Nx, Nth]; b f32 and x64_in f64 [C, 2, 2, Nx, Nth];
// conv_in, conv: one byte per chain (0 or 1); iters_in, iters, fb_iters:
// int32 [C]; s64: f64 [C, 32 * Nx * Nth].
extern "C" int cg_fallback_launch(const void* thE, const void* thO, const void* b,
                                  const void* x64_in, const void* conv_in, const void* iters_in,
                                  void* x, void* x64, void* iters, void* fb_iters, void* conv,
                                  void* s64, int C, int Nx, int Nth, double m0, double tol,
                                  double tau, int max_iter, int max_rounds, void* stream) {
  sm::cg_fallback_kernel<<<C, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thE), static_cast<const float*>(thO),
      static_cast<const float*>(b), static_cast<const double*>(x64_in),
      static_cast<const unsigned char*>(conv_in), static_cast<const int*>(iters_in),
      static_cast<float*>(x), static_cast<double*>(x64), static_cast<int*>(iters),
      static_cast<int*>(fb_iters), static_cast<unsigned char*>(conv),
      static_cast<double*>(s64), Nx, Nth, m0, tol, tau, max_iter, max_rounds);
  return static_cast<int>(cudaGetLastError());
}
