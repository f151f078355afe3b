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
// loop is cg_f32's without its breakdown guards, as the Pallas loop has
// none (a zero b runs one iteration to a NaN x, unconverged); the per-entry
// loop replaces the lockstep jnp.any of K6b and its block-indicator dots (a
// NaN entry stops only itself here). With a mask `active` (bool [C, B], or
// null for every entry) an inactive entry's block returns at once with x =
// x0, 0 iterations and rho = ||b||^2 = 0, and the active entries run as
// without it: the restart refinement's trailing passes (solvers/refine.py)
// cost a launch, not a solve. Outputs per entry: x, the iterations,
// the last recursive rho and ||b||^2; the wrapper forms
// converged = rho < f32(tol^2) ||b||^2 and the relative residual, as
// pallas_eo.py:315-323 and :494-503 do.
//
// What bounds it on the card: as K2, one normal apply (4 dependent stencil
// stages) and 2 block reductions per iteration on 2048 sites per entry at
// 64x64, i.e. what a thread waits for after each barrier, not bandwidth or
// flops. The whole loop runs in one block, so no host synchronisation or
// relaunch per iteration. Where its vectors live is chosen by lattice size
// before the launch (ops/cg_eo.cg_eo_path, K2's rule):
//
// - shared (up to 64x64): K2's CG store of shared_stencil.cuh without its
//   guards, the configuration's links copied into it (not built: every
//   entry of a configuration reads the same 64 KiB, which stay in L2), d, r
//   and two temporaries site-major, 96 bytes a site (192 KiB at 64x64, one
//   block an SM: C=32, B=8 runs in two waves), x in registers, 6 barriers an
//   iteration. Its sums add in block_sum's order, so where V2 is a multiple
//   of 512 x, the iterations and the flags are the global path's bit for bit;
// - global (a lattice no block holds, e.g. 128x128): r, d, Ad and the three
//   stencil temporaries (24 f32 values per half-lattice site and entry) in a
//   per-entry global scratch that stays in L2, cg_f32 of stencil.cuh,
//   11 barriers an iteration.
#include "shared_stencil.cuh"

namespace sm {

constexpr int kCgEoScratch = 24;  // f32 values per half-lattice site and entry

// An entry the mask leaves out: x = x0, no iteration, rho = ||b||^2 = 0.
__device__ __forceinline__ void skip_entry(const float* __restrict__ x0, float* __restrict__ x,
                                           int n, size_t e, int* __restrict__ iters_out,
                                           float* __restrict__ rho_out,
                                           float* __restrict__ bnorm_out) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = x0[i];
  if (threadIdx.x == 0) {
    iters_out[e] = 0;
    rho_out[e] = 0.0f;
    bnorm_out[e] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
cg_eo_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
             const float* __restrict__ b_all, const float* __restrict__ x0_all,
             float* __restrict__ x_all, int* __restrict__ iters_out,
             float* __restrict__ rho_out, float* __restrict__ bnorm_out,
             float* __restrict__ scratch, const bool* __restrict__ active, int B, int Nx,
             int Nth, float m, float c, double tol, int max_iter) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int e = blockIdx.x;
  const int cfg = e / B;
  if (active != nullptr && !active[e]) {
    const size_t off = (size_t)e * 4 * V2;
    skip_entry(x0_all + off, x_all + off, 4 * V2, e, iters_out, rho_out, bnorm_out);
    return;
  }
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

__global__ void __launch_bounds__(kThreads)
cg_eo_shared_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
                    const float* __restrict__ b_all, const float* __restrict__ x0_all,
                    float* __restrict__ x_all, int* __restrict__ iters_out,
                    float* __restrict__ rho_out, float* __restrict__ bnorm_out,
                    const bool* __restrict__ active, int B, int Nx, int Nth, float m, float c,
                    double tol, int max_iter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[2 * (kThreads / 32)];
  const Geo g{Nx, Nth, Nx * Nth};
  const size_t e = blockIdx.x, cfg = e / B;
  if (active != nullptr && !active[e]) {
    skip_entry(x0_all + e * 4 * g.V2, x_all + e * 4 * g.V2, 4 * g.V2, e, iters_out, rho_out,
               bnorm_out);
    return;
  }
  CgShared S = cg_shared(smem, sh, g, m, c);
  // visible after the CG's first barrier
  load_links_shared(ue_all + cfg * 4 * g.V2, S.ue, g);
  load_links_shared(uo_all + cfg * 4 * g.V2, S.uo, g);
  const CgOut o = S.solve<false>(b_all + e * 4 * g.V2, x0_all + e * 4 * g.V2, tol, max_iter);
  S.write_x(x_all + e * 4 * g.V2);
  if (threadIdx.x == 0) {
    iters_out[e] = o.iters;
    rho_out[e] = o.rho;
    bnorm_out[e] = o.bnorm2;
  }
}

// Dynamic shared memory of the shared path, 0 where it cannot hold the
// lattice.
size_t cg_eo_shared_bytes(int Nx, int Nth) {
  const size_t V2 = static_cast<size_t>(Nx) * Nth;
  const size_t bytes = kCgSharedBytes * V2;
  return V2 <= kOwnSites * kThreads && bytes <= kSharedMax ? bytes : 0;
}

}  // namespace sm

// path 0: the global scratch, f32 [C * B, 24 V2]; path 1: shared memory (at
// most 2048 sites, 96 V2 bytes), no scratch. active: bool [C, B], or null
// for every entry.
extern "C" int cg_eo_launch(const void* ue, const void* uo, const void* b, const void* x0,
                            void* x, void* iters, void* rho, void* bnorm, void* scratch, int C,
                            int B, int Nx, int Nth, double m0, double tol, int max_iter,
                            const void* active, int path, void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *u_e = static_cast<const float*>(ue), *u_o = static_cast<const float*>(uo);
  const float *bb = static_cast<const float*>(b), *xx0 = static_cast<const float*>(x0);
  const bool* act = static_cast<const bool*>(active);
  if (path == 0) {
    sm::cg_eo_kernel<<<C * B, sm::kThreads, 0, s>>>(
        u_e, u_o, bb, xx0, static_cast<float*>(x), static_cast<int*>(iters),
        static_cast<float*>(rho), static_cast<float*>(bnorm), static_cast<float*>(scratch), act,
        B, Nx, Nth, m, c, tol, max_iter);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = sm::cg_eo_shared_bytes(Nx, Nth);
  if (path != 1 || bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      sm::cg_eo_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  sm::cg_eo_shared_kernel<<<C * B, sm::kThreads, bytes, s>>>(
      u_e, u_o, bb, xx0, static_cast<float*>(x), static_cast<int*>(iters),
      static_cast<float*>(rho), static_cast<float*>(bnorm), act, B, Nx, Nth, m, c, tol,
      max_iter);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the path's kernel that one multiprocessor runs at once for an
// Nx x 2 Nth lattice (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with
// the path's dynamic shared memory), or minus the CUDA error.
extern "C" int cg_eo_blocks_per_sm(int Nx, int Nth, int path) {
  int n = 0;
  cudaError_t e;
  if (path == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sm::cg_eo_kernel, sm::kThreads, 0);
  } else {
    const size_t bytes = sm::cg_eo_shared_bytes(Nx, Nth);
    if (path != 1 || bytes == 0) return -static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(sm::cg_eo_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sm::cg_eo_shared_kernel,
                                                        sm::kThreads, bytes);
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
