// K6a/K6b: f32 CG on (Dhat Dhat^+) x = b with the links given.
//
// Replaces schwingermodel_tpu/ops/pallas_eo.py:_cg_kernel (one solve, K6a)
// and :_cg_kernel_mc (C solves lane-packed by the custom_vmap rule of
// cg_solve_eo_fused, K6b): one kernel, one thread block per entry
// (configuration c, right-hand side j), block e = c * B + j reading the
// folded links of configuration c. The links come in as f32 planes (the
// even-odd packed fermion links with the antiperiodic sign on u0), so the
// condensate's and the mesons' solves build them once per configuration
// and share them over every right-hand side and every refinement pass. The
// loop is stencil.cuh's cg_f32 without its breakdown guards, as the Pallas
// loop has none; the per-entry loop replaces the lockstep jnp.any of K6b
// and its block-indicator dots (a NaN entry stops only itself here).
// Outputs per entry: x, the iterations, the last recursive rho and
// ||b||^2; the wrapper forms converged = rho < f32(tol^2) ||b||^2 and the
// relative residual, as pallas_eo.py:315-323 and :494-503 do.
//
// What bounds it on the card: as K2, one normal apply (4 dependent stencil
// stages) and 2 block reductions per iteration on 2048 sites per entry at
// 64x64, i.e. barrier and L2 latency, not bandwidth or flops. Design: the
// whole loop runs in one block, so no host synchronisation or relaunch per
// iteration; r, d, Ad and the three stencil temporaries (24 f32 values per
// half-lattice site, 192 KB per entry at 64x64) live in a per-entry global
// scratch; at C=32 and B=8 the 256 blocks fill the card's 132 SMs about
// twice over.
#include "stencil.cuh"

namespace sm {

constexpr int kCgEoScratch = 24;  // f32 values per half-lattice site and entry

__global__ void __launch_bounds__(kThreads)
cg_eo_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
             const float* __restrict__ b_all, const float* __restrict__ x0_all,
             float* __restrict__ x_all, int* __restrict__ iters_out,
             float* __restrict__ rho_out, float* __restrict__ bnorm_out,
             float* __restrict__ scratch, int B, int Nx, int Nth, float m, float c,
             double tol, int max_iter) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int e = blockIdx.x;
  const int cfg = e / B;
  const float* ue = ue_all + (size_t)cfg * 4 * V2;
  const float* uo = uo_all + (size_t)cfg * 4 * V2;
  float* sc = scratch + (size_t)e * kCgEoScratch * V2;
  const size_t off = (size_t)e * 4 * V2;
  const CgOut o = cg_f32<false>(ue, uo, b_all + off, x0_all + off, x_all + off, sc, sc + 4 * V2,
                                sc + 8 * V2, sc + 12 * V2, sc + 16 * V2, sc + 20 * V2, m, c, tol,
                                max_iter, g, sh);
  if (threadIdx.x == 0) {
    iters_out[e] = o.iters;
    rho_out[e] = o.rho;
    bnorm_out[e] = o.bnorm2;
  }
}

}  // namespace sm

extern "C" int cg_eo_launch(const void* ue, const void* uo, const void* b, const void* x0,
                            void* x, void* iters, void* rho, void* bnorm, void* scratch, int C,
                            int B, int Nx, int Nth, double m0, double tol, int max_iter,
                            void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  sm::cg_eo_kernel<<<C * B, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ue), static_cast<const float*>(uo), static_cast<const float*>(b),
      static_cast<const float*>(x0), static_cast<float*>(x), static_cast<int*>(iters),
      static_cast<float*>(rho), static_cast<float*>(bnorm), static_cast<float*>(scratch), B, Nx,
      Nth, m, c, tol, max_iter);
  return static_cast<int>(cudaGetLastError());
}
