// K5: the Hasenbusch ratio force with the staple force.
//
// Replaces schwingermodel_tpu/ops/pallas_traj.py:_ratio_force_kernel
// (ratio_force_fused). For S2 = (Dhat1 phi2)^+ (Dhat0 Dhat0^+)^{-1}
// (Dhat1 phi2) at the solved psi = (Dhat0 Dhat0^+)^{-1} Dhat1 phi2 and
// chi' = Dhat0^+ psi (built here, with m0+2 and c0),
//     F2 = ff(psi, chi'; c0) - ff(psi, phi2; c1) + staples,
// with c_m = 1/(4(m+2)) and ff(x, y; c) = 2c f(x (+) b, y (+) H_oe y),
// b = (H_eo)^+ psi shared by both bilinears. The staple force is added here
// and only here: the heavy term's K1 runs with_gauge=false.
//
// What bounds it on the card: as K1 without the CG, a few dependent
// stencil stages per chain, so latency (the launch, the first reads,
// sincosf, four barriers), not bytes or flops. Where its fields live is
// chosen by lattice size and chain count before the launch
// (ops/traj.ratio_force_path, K1's rule without the solve, with staples):
//
// - shared (up to 64x64 on one block, 128x128 on 8): K1's shared kernel body
//   (force_shared.cuh) with the two bilinears folded into one,
//   2 f(psi (+) b, Y (+) H_oe Y) with Y = c0 chi' - c1 phi2 (f is real-linear
//   in y): the store, the stages and the blocks a chain of K1 without the
//   solve, phi2 read at the block's sites where chi' is formed. The fold
//   rounds in another order than the two bilinears, so the forces are not
//   the global path's bit for bit;
// - global (a lattice no split holds, e.g. 256x256): one thread block per
//   chain, the two bilinears as written above, intermediates (links, b,
//   chi', H_oe chi', H_oe phi2, plaquette angles: 26 f32 values per
//   half-lattice site) in a per-chain global scratch that stays in L2.
#include "force_shared.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
ratio_force_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                   const float* __restrict__ psi_all, const float* __restrict__ phi2_all,
                   float* __restrict__ FE_all, float* __restrict__ FO_all,
                   float* __restrict__ scratch, int Nx, int Nth, float m0f, float c0, float c1,
                   float beta) {
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int ch = blockIdx.x;
  const float* psi = psi_all + (size_t)ch * 4 * V2;
  const float* phi2 = phi2_all + (size_t)ch * 4 * V2;
  float* FE = FE_all + (size_t)ch * 2 * V2;
  float* FO = FO_all + (size_t)ch * 2 * V2;
  float* sc = scratch + (size_t)ch * 26 * V2;
  float* ue = sc;
  float* uo = sc + 4 * V2;
  float* bo = sc + 8 * V2;    // (H_eo)^+ psi, odd
  float* chi = sc + 12 * V2;  // Dhat0^+ psi, even
  float* ao = sc + 16 * V2;   // H_oe chi, odd
  float* a2 = sc + 20 * V2;   // H_oe phi2, odd
  float* se = sc + 24 * V2;   // Im P at even sites
  float* so = sc + 25 * V2;   // Im P at odd sites

  make_links<float>(thE + (size_t)ch * 2 * V2, 0, ue, g);
  make_links<float>(thO + (size_t)ch * 2 * V2, 1, uo, g);
  __syncthreads();
  hop_stage<float, true>(uo, ue, psi, 1, bo, nullptr, 0.f, 0.f, g);
  hop_stage<float, false>(uo, ue, phi2, 1, a2, nullptr, 0.f, 0.f, g);
  __syncthreads();
  hop_stage<float, true>(ue, uo, bo, 0, chi, psi, m0f, -c0, g);
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    const int x = s / Nth;
    const int k = s - x * Nth;
    const Nbr ne = neighbours(x, k, x & 1, g);
    const Nbr no = neighbours(x, k, (x + 1) & 1, g);
    se[s] = cmul(cmul(ld(ue, 0, s, V2), ld(uo, 1, ne.pt, V2)),
                 cconj(cmul(ld(uo, 0, ne.px, V2), ld(ue, 1, s, V2)))).im;
    so[s] = cmul(cmul(ld(uo, 0, s, V2), ld(ue, 1, no.pt, V2)),
                 cconj(cmul(ld(ue, 0, no.px, V2), ld(uo, 1, s, V2)))).im;
  }
  __syncthreads();
  hop_stage<float, false>(uo, ue, chi, 1, ao, nullptr, 0.f, 0.f, g);
  __syncthreads();

  const float two_c0 = 2.0f * c0, two_c1 = 2.0f * c1;
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    const int x = s / Nth;
    const int k = s - x * Nth;
    const Nbr ne = neighbours(x, k, x & 1, g);
    const Nbr no = neighbours(x, k, (x + 1) & 1, g);
    float f0, f1, h0, h1;
    // even sites: x = psi; y = chi' (light term) and y = phi2 (heavy term)
    fermion_force_site(ue, psi, chi, bo, ao, s, ne, V2, f0, f1);
    fermion_force_site(ue, psi, phi2, bo, a2, s, ne, V2, h0, h1);
    FE[s] = (two_c0 * f0 - two_c1 * h0) + (-beta * (se[s] - so[ne.mx]));
    FE[V2 + s] = (two_c0 * f1 - two_c1 * h1) + beta * (se[s] - so[ne.mt]);
    // odd sites: x = b; y = H_oe chi' and y = H_oe phi2
    fermion_force_site(uo, bo, ao, psi, chi, s, no, V2, f0, f1);
    fermion_force_site(uo, bo, a2, psi, phi2, s, no, V2, h0, h1);
    FO[s] = (two_c0 * f0 - two_c1 * h0) + (-beta * (so[s] - se[no.mx]));
    FO[V2 + s] = (two_c0 * f1 - two_c1 * h1) + beta * (so[s] - se[no.mt]);
  }
}

}  // namespace sm

// path 0: the global scratch, f32 [C, 26 V2]; path 1: K1's shared kernel
// body, `blocks` blocks a chain (a divisor of Nx whose rows, with kHaloW rows
// on either side, hold at most 2048 sites), no scratch.
extern "C" int ratio_force_launch(const void* thE, const void* thO, const void* psi,
                                  const void* phi2, void* FE, void* FO, void* scratch, int C,
                                  int Nx, int Nth, double m0, double m1, double beta, int path,
                                  int blocks, void* stream) {
  const float m0f = static_cast<float>(m0 + 2.0);
  const float c0 = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const float c1 = static_cast<float>(1.0 / (4.0 * (m1 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *th_e = static_cast<const float*>(thE), *th_o = static_cast<const float*>(thO);
  const float *ps = static_cast<const float*>(psi), *p2 = static_cast<const float*>(phi2);
  if (path == 0) {
    sm::ratio_force_kernel<<<C, sm::kThreads, 0, s>>>(
        th_e, th_o, ps, p2, static_cast<float*>(FE), static_cast<float*>(FO),
        static_cast<float*>(scratch), Nx, Nth, m0f, c0, c1, static_cast<float>(beta));
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 1) return static_cast<int>(cudaErrorInvalidValue);
  return sm::launch_shared<false, true, true>(
      th_e, th_o, p2, ps, nullptr, static_cast<float*>(FE), static_cast<float*>(FO), nullptr,
      nullptr, C, Nx, Nth, m0f, c0, c1, static_cast<float>(beta), 0.0, 0, blocks, s);
}
