// K2: the f32 solve on (Dhat Dhat^+) x = b, the loose contract.
//
// Replaces schwingermodel_tpu/ops/pallas_traj.py:_solve_kernel
// (solve_fused): the links are built in-kernel from the angle planes, then
// the f32 CG loop of cg_f32_op (the per-chain form of pallas_traj._cg_planes)
// runs from x0. Outputs per chain: x, the iterations, the last recursive rho
// and ||b||^2; the wrapper forms converged = rho < f32(tol^2) ||b||^2 and
// the relative residual from them, as solve_fused does.
//
// What bounds it on the card: per iteration one normal apply (4 dependent
// stencil stages of ~150 flops per site) and 2 block reductions on 2048
// sites per chain at 64x64, i.e. what a thread waits for after each
// barrier, not bandwidth or flops. One thread block per chain runs the whole
// loop, so no host synchronisation or relaunch happens per iteration. Where
// its vectors live is chosen by lattice size before the launch
// (ops/traj.cg_path):
//
// - shared (up to 64x64): the CG store of shared_stencil.cuh, the links of
//   both parities, d, r and two stencil temporaries in the block's shared
//   memory, site-major (96 bytes a site, 192 KiB at 64x64), x in registers,
//   the <d, Ad> partial formed in the fourth stage, a block sum one barrier:
//   6 barriers an iteration, none followed by a trip to L2. Its sums add in
//   block_sum's order, so where a thread's sites are its planar indices (V2
//   a multiple of 512) x has the bits of the global path;
// - global (a lattice no block holds, e.g. 128x128): links, r, d, Ad and the
//   stencil temporaries (32 f32 values per half-lattice site) in a per-chain
//   global scratch that stays in L2, cg_f32 of stencil.cuh, 11 barriers an
//   iteration.
#include "shared_stencil.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
solve_fused_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                   const float* __restrict__ b_all, const float* __restrict__ x0_all,
                   float* __restrict__ x_all, int* __restrict__ iters_out,
                   float* __restrict__ rho_out, float* __restrict__ bnorm_out,
                   float* __restrict__ scratch, int Nx, int Nth, float m, float c, double tol,
                   int max_iter) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int ch = blockIdx.x;
  float* sc = scratch + (size_t)ch * 32 * V2;
  float *ue = sc, *uo = sc + 4 * V2;
  make_links<float>(thE + (size_t)ch * 2 * V2, 0, ue, g);
  make_links<float>(thO + (size_t)ch * 2 * V2, 1, uo, g);
  const CgOut o = cg_f32(ue, uo, b_all + (size_t)ch * 4 * V2, x0_all + (size_t)ch * 4 * V2,
                         x_all + (size_t)ch * 4 * V2, sc + 8 * V2, sc + 12 * V2, sc + 16 * V2,
                         sc + 20 * V2, sc + 24 * V2, sc + 28 * V2, m, c, tol, max_iter, g, sh);
  if (threadIdx.x == 0) {
    iters_out[ch] = o.iters;
    rho_out[ch] = o.rho;
    bnorm_out[ch] = o.bnorm2;
  }
}

__global__ void __launch_bounds__(kThreads)
solve_shared_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                    const float* __restrict__ b_all, const float* __restrict__ x0_all,
                    float* __restrict__ x_all, int* __restrict__ iters_out,
                    float* __restrict__ rho_out, float* __restrict__ bnorm_out, int Nx,
                    int Nth, float m, float c, double tol, int max_iter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[2 * (kThreads / 32)];
  const Geo g{Nx, Nth, Nx * Nth};
  const size_t ch = blockIdx.x;
  CgShared S = cg_shared(smem, sh, g, m, c);
  make_links_shared(thE + ch * 2 * g.V2, 0, S.ue, g);
  make_links_shared(thO + ch * 2 * g.V2, 1, S.uo, g);
  const CgOut o = S.solve(b_all + ch * 4 * g.V2, x0_all + ch * 4 * g.V2, tol, max_iter);
  S.write_x(x_all + ch * 4 * g.V2);
  if (threadIdx.x == 0) {
    iters_out[ch] = o.iters;
    rho_out[ch] = o.rho;
    bnorm_out[ch] = o.bnorm2;
  }
}

}  // namespace sm

// path 0: the global scratch, f32 [C, 32 V2]; path 1: shared memory (at
// most 2048 sites, 96 V2 bytes), no scratch.
extern "C" int solve_fused_launch(const void* thE, const void* thO, const void* b, const void* x0,
                                  void* x, void* iters, void* rho, void* bnorm, void* scratch,
                                  int C, int Nx, int Nth, double m0, double tol, int max_iter,
                                  int path, void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *th_e = static_cast<const float*>(thE), *th_o = static_cast<const float*>(thO);
  const float *bb = static_cast<const float*>(b), *xx0 = static_cast<const float*>(x0);
  if (path == 0) {
    sm::solve_fused_kernel<<<C, sm::kThreads, 0, s>>>(
        th_e, th_o, bb, xx0, static_cast<float*>(x), static_cast<int*>(iters),
        static_cast<float*>(rho), static_cast<float*>(bnorm), static_cast<float*>(scratch), Nx,
        Nth, m, c, tol, max_iter);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t V2 = static_cast<size_t>(Nx) * Nth;
  const size_t bytes = sm::kCgSharedBytes * V2;
  if (path != 1 || V2 > sm::kOwnSites * sm::kThreads || bytes > sm::kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      sm::solve_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  sm::solve_shared_kernel<<<C, sm::kThreads, bytes, s>>>(
      th_e, th_o, bb, xx0, static_cast<float*>(x), static_cast<int*>(iters),
      static_cast<float*>(rho), static_cast<float*>(bnorm), Nx, Nth, m, c, tol, max_iter);
  return static_cast<int>(cudaGetLastError());
}
