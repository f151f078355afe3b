// K8: the per-shard MD force on the width-4-extended block.
//
// Replaces schwingermodel_tpu/ops/pallas_halo.py:_halo_force_kernel
// (force_halo_fused). From the extended f32 planes (both parities' folded
// links, psi, the even-parity row offsets from the global x) it forms
// b = (H_eo)^+ psi, chi' = Dhat^+ psi, a = H_oe chi', the plaquette angles,
// and on the kept interior the checkerboard fermion force
// 2c f(x = psi (+) b, y = a (+) chi') plus the staple force
// F0 = -beta [sin P(n) - sin P(n-x)], F1 = beta [sin P(n) - sin P(n-t)]:
// K1's arithmetic (force_step.cu) with the extended block's plain periodic
// neighbours and the offsets as an input. The rings are consumed exactly:
// 2 by Dhat^+, 1 by a and b, 1 by the force stencil's gathers at n+t, n+x
// (and by the staples' n-x, n-t). The halo exchange stays outside.
//
// What bounds it on the card: launch latency, as K7 (one block reads ~46 KB
// and writes 4 KB). Design: one thread block per (chain, shard); inputs and
// the intermediates b, chi', a and the two plaquette planes are 26 planes
// of the extended block, 100 KB at 64x64 over 2x2, kept in shared memory
// with three barriers between the stages; a block above 220 KB reads its
// inputs from global memory and keeps the intermediates in a scratch.
#include "stencil.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
halo_force_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
                  const int* __restrict__ off_all, const float* __restrict__ psi_all,
                  float* __restrict__ FE_all, float* __restrict__ FO_all,
                  float* __restrict__ scratch, int Nxe, int Nthe, float m, float c, float beta) {
  extern __shared__ __align__(16) float smem[];
  const Geo g{Nxe, Nthe, Nxe * Nthe};
  const int V = g.V2;
  const size_t blk = blockIdx.x;
  const float* ue = ue_all + blk * 4 * V;
  const float* uo = uo_all + blk * 4 * V;
  const float* psi = psi_all + blk * 4 * V;
  const int* off = off_all + blk * Nxe;
  float* w;
  if (scratch == nullptr) {
    copy_in(smem, ue, 4 * V);
    copy_in(smem + 4 * V, uo, 4 * V);
    copy_in(smem + 8 * V, psi, 4 * V);
    ue = smem;
    uo = smem + 4 * V;
    psi = smem + 8 * V;
    w = smem + 12 * V;
    __syncthreads();
  } else {
    w = scratch + blk * 14 * V;
  }
  float* bo = w;            // (H_eo)^+ psi, odd
  float* chi = w + 4 * V;   // Dhat^+ psi, even
  float* ao = w + 8 * V;    // H_oe chi, odd
  float* se = w + 12 * V;   // Im P at even sites
  float* so = w + 13 * V;   // Im P at odd sites

  hop_stage_ext<float, true>(uo, ue, psi, off, 1, bo, nullptr, 0.f, 0.f, g);
  for (int s = threadIdx.x; s < V; s += blockDim.x) {
    const int x = s / Nthe;
    const int k = s - x * Nthe;
    // P(n) = u0(n) u1(n+t) conj(u0(n+x) u1(n)), anchored at both parities
    const Nbr ne = neighbours(x, k, off[x], g);
    const Nbr no = neighbours(x, k, off[x] ^ 1, g);
    se[s] = cmul(cmul(ld(ue, 0, s, V), ld(uo, 1, ne.pt, V)),
                 cconj(cmul(ld(uo, 0, ne.px, V), ld(ue, 1, s, V)))).im;
    so[s] = cmul(cmul(ld(uo, 0, s, V), ld(ue, 1, no.pt, V)),
                 cconj(cmul(ld(ue, 0, no.px, V), ld(uo, 1, s, V)))).im;
  }
  __syncthreads();
  hop_stage_ext<float, true>(ue, uo, bo, off, 0, chi, psi, m, -c, g);
  __syncthreads();
  hop_stage_ext<float, false>(uo, ue, chi, off, 1, ao, nullptr, 0.f, 0.f, g);
  __syncthreads();

  const int Nx = Nxe - 2 * kHaloW, Nth = Nthe - 2 * kHaloW, Vl = Nx * Nth;
  float* FE = FE_all + blk * 2 * Vl;
  float* FO = FO_all + blk * 2 * Vl;
  const float two_c = 2.0f * c;
  for (int i = threadIdx.x; i < Vl; i += blockDim.x) {
    const int xl = i / Nth;
    const int x = xl + kHaloW, k = i - xl * Nth + kHaloW;
    const int s = x * Nthe + k;
    const Nbr ne = neighbours(x, k, off[x], g);
    const Nbr no = neighbours(x, k, off[x] ^ 1, g);
    float f0, f1;
    // even sites: x = psi, y = chi'; the odd operands are b and a
    fermion_force_site(ue, psi, chi, bo, ao, s, ne, V, f0, f1);
    FE[i] = two_c * f0 + (-beta * (se[s] - so[ne.mx]));
    FE[Vl + i] = two_c * f1 + beta * (se[s] - so[ne.mt]);
    // odd sites: x = b, y = a; the even operands are psi and chi'
    fermion_force_site(uo, bo, ao, psi, chi, s, no, V, f0, f1);
    FO[i] = two_c * f0 + (-beta * (so[s] - se[no.mx]));
    FO[Vl + i] = two_c * f1 + beta * (so[s] - se[no.mt]);
  }
}

}  // namespace sm

// ue, uo, psi: f32 [n_blocks, 2, 2, Nxe, Nthe]; off: int32 [n_blocks, Nxe];
// FE, FO: f32 [n_blocks, 2, Nxe-8, Nthe-8]. scratch: null to keep the block
// in shared memory (26 * Nxe * Nthe floats, at most 220 KB), else f32
// [n_blocks, 14 * Nxe * Nthe].
extern "C" int halo_force_launch(const void* ue, const void* uo, const void* off, const void* psi,
                                 void* FE, void* FO, void* scratch, int n_blocks, int Nxe,
                                 int Nthe, double m0, double beta, void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  size_t shared = 0;
  if (scratch == nullptr) {
    shared = sizeof(float) * 26 * Nxe * Nthe;
    if (shared > sm::kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        cudaFuncSetAttribute(sm::halo_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm::kSharedMax);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sm::halo_force_kernel<<<n_blocks, sm::kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ue), static_cast<const float*>(uo),
      static_cast<const int*>(off), static_cast<const float*>(psi), static_cast<float*>(FE),
      static_cast<float*>(FO), static_cast<float*>(scratch), Nxe, Nthe, m, c,
      static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}
