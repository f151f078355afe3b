// K1: the fused MD force step.
//
// Replaces schwingermodel_tpu/ops/pallas_traj.py:_force_step_kernel
// (force_step_fused, with_solve=False, with_gauge=True): from the angle
// planes and the solved psi = (Dhat Dhat^+)^{-1} Phi it builds the links,
// chi' = Dhat^+ psi, the checkerboard fermion force 2c f(x = psi (+) b,
// y = a (+) chi') with a = H_oe chi', b = (H_eo)^+ psi, and the staple force
// F0 = -beta [sin P(n) - sin P(n-x)], F1 = beta [sin P(n) - sin P(n-t)].
//
// What bounds it on the card: nothing of the arithmetic (a few hundred
// flops per site); one chain is 2048 sites at 64x64, so the kernel is a
// short chain of dependent stencil stages whose cost is barrier and L2
// latency. Design: one thread block per chain and one launch per force
// step, with every intermediate (links, b, chi', a, plaquette angles) in a
// per-chain global scratch that stays in L2; stages are separated by
// __syncthreads(). At C=32 this fills 32 of the 132 SMs; spreading a chain
// over a cluster is later work.
#include "stencil.cuh"

namespace sm {

// Reference force stencil f_mu at one parity-p site: left operand x, right
// operand y; *_p on-site (parity p), *_q the opposite parity gathered at
// n+t and n+x (pallas_traj._fermion_force_p).
__device__ __forceinline__ void fermion_force_site(const float* u, const float* xp,
                                                   const float* yp, const float* xq,
                                                   const float* yq, int s, const Nbr& n,
                                                   int V2, float& f0, float& f1) {
  const Cx<float> u0 = ld(u, 0, s, V2), u1 = ld(u, 1, s, V2);
  const Cx<float> x0 = ld(xp, 0, s, V2), x1 = ld(xp, 1, s, V2);
  const Cx<float> y0 = ld(yp, 0, s, V2), y1 = ld(yp, 1, s, V2);
  const Cx<float> yt = csub(ld(yq, 0, n.pt, V2), ld(yq, 1, n.pt, V2));
  const Cx<float> xt = cadd(ld(xq, 0, n.pt, V2), ld(xq, 1, n.pt, V2));
  const Cx<float> yx = cadd(ld(yq, 0, n.px, V2), cmuli(ld(yq, 1, n.px, V2)));
  const Cx<float> xx = csub(ld(xq, 0, n.px, V2), cmuli(ld(xq, 1, n.px, V2)));
  f0 = cmul(u0, cmul(cconj(csub(x0, x1)), yt)).im -
       cmul(cconj(u0), cmul(cconj(xt), cadd(y0, y1))).im;
  f1 = cmul(u1, cmul(cconj(cadd(x0, cmuli(x1))), yx)).im +
       cmul(cconj(u1), cmul(cconj(xx), cadd(cneg(y0), cmuli(y1)))).im;
}

__global__ void __launch_bounds__(kThreads)
force_step_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                  const float* __restrict__ psi_all, float* __restrict__ FE_all,
                  float* __restrict__ FO_all, float* __restrict__ scratch, int Nx, int Nth,
                  float m, float c, float beta) {
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int ch = blockIdx.x;
  const float* the = thE + (size_t)ch * 2 * V2;
  const float* tho = thO + (size_t)ch * 2 * V2;
  const float* psi = psi_all + (size_t)ch * 4 * V2;
  float* FE = FE_all + (size_t)ch * 2 * V2;
  float* FO = FO_all + (size_t)ch * 2 * V2;
  float* sc = scratch + (size_t)ch * 22 * V2;
  float* ue = sc;
  float* uo = sc + 4 * V2;
  float* bo = sc + 8 * V2;    // (H_eo)^+ psi, odd
  float* chi = sc + 12 * V2;  // Dhat^+ psi, even
  float* ao = sc + 16 * V2;   // H_oe chi, odd
  float* se = sc + 20 * V2;   // Im P at even sites
  float* so = sc + 21 * V2;   // Im P at odd sites

  make_links<float>(the, 0, ue, g);
  make_links<float>(tho, 1, uo, g);
  __syncthreads();
  hop_stage<float, true>(uo, ue, psi, 1, bo, nullptr, 0.f, 0.f, g);
  __syncthreads();
  hop_stage<float, true>(ue, uo, bo, 0, chi, psi, m, -c, g);
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    const int x = s / Nth;
    const int k = s - x * Nth;
    // P(n) = u0(n) u1(n+t) conj(u0(n+x) u1(n)), anchored at both parities
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

  const float two_c = 2.0f * c;
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    const int x = s / Nth;
    const int k = s - x * Nth;
    const Nbr ne = neighbours(x, k, x & 1, g);
    const Nbr no = neighbours(x, k, (x + 1) & 1, g);
    float f0, f1;
    // even sites: x = psi, y = chi'; the odd operands are b and a
    fermion_force_site(ue, psi, chi, bo, ao, s, ne, V2, f0, f1);
    FE[s] = two_c * f0 + (-beta * (se[s] - so[ne.mx]));
    FE[V2 + s] = two_c * f1 + beta * (se[s] - so[ne.mt]);
    // odd sites: x = b, y = a; the even operands are psi and chi'
    fermion_force_site(uo, bo, ao, psi, chi, s, no, V2, f0, f1);
    FO[s] = two_c * f0 + (-beta * (so[s] - se[no.mx]));
    FO[V2 + s] = two_c * f1 + beta * (so[s] - se[no.mt]);
  }
}

}  // namespace sm

extern "C" int force_step_launch(const void* thE, const void* thO, const void* psi, void* FE,
                                 void* FO, void* scratch, int C, int Nx, int Nth, double m0,
                                 double beta, void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  sm::force_step_kernel<<<C, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thE), static_cast<const float*>(thO),
      static_cast<const float*>(psi), static_cast<float*>(FE), static_cast<float*>(FO),
      static_cast<float*>(scratch), Nx, Nth, m, c, static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}
