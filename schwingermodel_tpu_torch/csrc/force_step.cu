// K1: the fused MD force step.
//
// Replaces schwingermodel_tpu/ops/pallas_traj.py:_force_step_kernel
// (force_step_fused) in its four variants. From the angle planes it builds
// the links; with_solve runs the f32 CG of cg_f32_op on
// (Dhat Dhat^+) psi = phi from x0 in the same launch, otherwise psi = x0 was
// solved outside; then chi' = Dhat^+ psi, the checkerboard fermion force
// 2c f(x = psi (+) b, y = a (+) chi') with a = H_oe chi', b = (H_eo)^+ psi,
// and, with_gauge, the staple force F0 = -beta [sin P(n) - sin P(n-x)],
// F1 = beta [sin P(n) - sin P(n-t)]. with_gauge=false is the Hasenbusch
// heavy term, whose staples the ratio kernel (K5) adds.
//
// What bounds it on the card: nothing of the arithmetic (a few hundred
// flops per site) or of the bytes (0.94 us at 64x64 C=32 without the solve):
// a chain is 2048 sites at 64x64, so the kernel is a short chain of
// dependent stencil stages, and with the CG a loop of them, whose cost is
// what a thread waits for after each barrier. Design: every field in shared
// memory (shared_stencil.cuh; the force stages in force_shared.cuh, whose
// body K5 runs too), site-major, one 16-byte load a neighbour's spinor, no
// trip to L2 between stages. Where the kernel keeps its fields
// is chosen by lattice size and chain count before the launch
// (ops/traj.cg_path):
//
// - shared, with the solve (up to 64x64): one block a chain; the CG store of
//   shared_stencil.cuh (links, d, r, two temporaries: 96 bytes a site; x in
//   registers, 6 barriers an iteration), then the force stages on the same
//   buffers: psi from the registers into d's place, b, chi' and a into r's
//   and the temporaries', the plaquette angles 8 bytes a site more (104 in
//   all, 208 KiB at 64x64);
// - shared, without the solve: psi read into shared memory, then four
//   stages and four barriers. n blocks a chain (n from the chain count, to
//   fill the card's multiprocessors where one block a chain leaves most of
//   them idle): each holds its Nx / n rows between kHaloW rows of the
//   neighbouring rows on either side, read from the angles and psi and
//   computed again, so the blocks share nothing and a barrier is a
//   __syncthreads(): each stage spoils one row at either edge, and the four
//   rows left the force exact on the block's own rows;
// - global (a lattice no block holds, e.g. 128x128): one block a chain with
//   every intermediate (links, b, chi', a, plaquette angles, and with the CG
//   r, d, Ad) in a per-chain global scratch that stays in L2; the CG's three
//   stencil temporaries reuse the b, chi' and a planes.
#include "force_shared.cuh"

namespace sm {

template <bool WITH_SOLVE, bool WITH_GAUGE>
__global__ void __launch_bounds__(kThreads)
force_step_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                  const float* __restrict__ phi_all, const float* __restrict__ x0_all,
                  float* __restrict__ psi_all, float* __restrict__ FE_all,
                  float* __restrict__ FO_all, int* __restrict__ iters_out,
                  unsigned char* __restrict__ conv_out, float* __restrict__ scratch, int Nx,
                  int Nth, float m, float c, float beta, double tol, int max_iter) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int ch = blockIdx.x;
  const float* the = thE + (size_t)ch * 2 * V2;
  const float* tho = thO + (size_t)ch * 2 * V2;
  const float* x0 = x0_all + (size_t)ch * 4 * V2;
  float* FE = FE_all + (size_t)ch * 2 * V2;
  float* FO = FO_all + (size_t)ch * 2 * V2;
  float* sc = scratch + (size_t)ch * (WITH_SOLVE ? 34 : 22) * V2;
  float* ue = sc;
  float* uo = sc + 4 * V2;
  float* bo = sc + 8 * V2;    // (H_eo)^+ psi, odd
  float* chi = sc + 12 * V2;  // Dhat^+ psi, even
  float* ao = sc + 16 * V2;   // H_oe chi, odd
  float* se = sc + 20 * V2;   // Im P at even sites
  float* so = sc + 21 * V2;   // Im P at odd sites

  make_links<float>(the, 0, ue, g);
  make_links<float>(tho, 1, uo, g);
  const float* psi = x0;
  if (WITH_SOLVE) {
    float* x = psi_all + (size_t)ch * 4 * V2;
    const CgOut o = cg_f32(ue, uo, phi_all + (size_t)ch * 4 * V2, x0, x, sc + 22 * V2,
                           sc + 26 * V2, sc + 30 * V2, bo, chi, ao, m, c, tol, max_iter, g, sh);
    if (threadIdx.x == 0) {
      iters_out[ch] = o.iters;
      conv_out[ch] = o.rho < static_cast<float>(tol * tol) * o.bnorm2;
    }
    psi = x;
  } else {
    if (threadIdx.x == 0) {
      iters_out[ch] = 0;
      conv_out[ch] = 1;
    }
    __syncthreads();
  }
  hop_stage<float, true>(uo, ue, psi, 1, bo, nullptr, 0.f, 0.f, g);
  __syncthreads();
  hop_stage<float, true>(ue, uo, bo, 0, chi, psi, m, -c, g);
  if (WITH_GAUGE) {
    for (int s = threadIdx.x; s < V2; s += blockDim.x) {
      const int x = s / Nth;
      const int k = s - x * Nth;
      plaq_pair_planar(ue, uo, s, neighbours(x, k, x & 1, g),
                       neighbours(x, k, (x + 1) & 1, g), V2, se, so);
    }
  }
  __syncthreads();
  hop_stage<float, false>(uo, ue, chi, 1, ao, nullptr, 0.f, 0.f, g);
  __syncthreads();

  const float two_c = 2.0f * c;
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    const int x = s / Nth;
    const int k = s - x * Nth;
    force_pair_planar<WITH_GAUGE>(ue, uo, psi, chi, bo, ao, se, so, s,
                                  neighbours(x, k, x & 1, g), neighbours(x, k, (x + 1) & 1, g),
                                  V2, two_c, beta, FE, FO, s, V2);
  }
}

template <bool S, bool G>
int launch(const void* thE, const void* thO, const void* phi, const void* x0, void* psi,
           void* FE, void* FO, void* iters, void* conv, void* scratch, int C, int Nx, int Nth,
           float m, float c, float beta, double tol, int max_iter, int path, int blocks,
           cudaStream_t stream) {
  const float* th_e = static_cast<const float*>(thE);
  const float* th_o = static_cast<const float*>(thO);
  if (path == 0) {
    force_step_kernel<S, G><<<C, kThreads, 0, stream>>>(
        th_e, th_o, static_cast<const float*>(phi), static_cast<const float*>(x0),
        static_cast<float*>(psi), static_cast<float*>(FE), static_cast<float*>(FO),
        static_cast<int*>(iters), static_cast<unsigned char*>(conv),
        static_cast<float*>(scratch), Nx, Nth, m, c, beta, tol, max_iter);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_shared<S, G>(th_e, th_o, static_cast<const float*>(phi),
                             static_cast<const float*>(x0), static_cast<float*>(psi),
                             static_cast<float*>(FE), static_cast<float*>(FO),
                             static_cast<int*>(iters), static_cast<unsigned char*>(conv), C, Nx,
                             Nth, m, c, 0.f, beta, tol, max_iter, blocks, stream);
}

}  // namespace sm

// phi and psi are read or written only with_solve; iters and conv (bool)
// are written in every variant (0 and true without the solve). path 0: the
// global scratch, f32 [C, 34 V2] with the solve and [C, 22 V2] without;
// path 1: shared memory, `blocks` blocks a chain (1 with the solve; without
// it a divisor of Nx whose rows, with kHaloW rows on either side, hold at
// most 2048 sites), no scratch.
extern "C" int force_step_launch(const void* thE, const void* thO, const void* phi,
                                 const void* x0, void* psi, void* FE, void* FO, void* iters,
                                 void* conv, void* scratch, int C, int Nx, int Nth,
                                 double m0, double beta, double tol, int max_iter,
                                 int with_solve, int with_gauge, int path, int blocks,
                                 void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const float b = static_cast<float>(beta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_solve && with_gauge)
    return sm::launch<true, true>(thE, thO, phi, x0, psi, FE, FO, iters, conv, scratch, C, Nx,
                                  Nth, m, c, b, tol, max_iter, path, blocks, s);
  if (with_solve)
    return sm::launch<true, false>(thE, thO, phi, x0, psi, FE, FO, iters, conv, scratch, C,
                                   Nx, Nth, m, c, b, tol, max_iter, path, blocks, s);
  if (with_gauge)
    return sm::launch<false, true>(thE, thO, phi, x0, psi, FE, FO, iters, conv, scratch, C,
                                   Nx, Nth, m, c, b, tol, max_iter, path, blocks, s);
  return sm::launch<false, false>(thE, thO, phi, x0, psi, FE, FO, iters, conv, scratch, C, Nx,
                                  Nth, m, c, b, tol, max_iter, path, blocks, s);
}
