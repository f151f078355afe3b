// K8: the per-shard MD force on the width-4-extended block.
//
// Replaces schwingermodel_tpu/ops/pallas_halo.py:_halo_force_kernel
// (force_halo_fused). From the extended f32 planes (both parities' folded
// links, psi, the even-parity row offsets from the global x) it forms
// b = (H_eo)^+ psi, chi' = Dhat^+ psi, a = H_oe chi', the plaquette angles,
// and on the kept interior the checkerboard fermion force
// 2c f(x = psi (+) b, y = a (+) chi') plus the staple force
// F0 = -beta [sin P(n) - sin P(n-x)], F1 = beta [sin P(n) - sin P(n-t)]:
// K1's arithmetic with the extended block's plain periodic neighbours and
// the offsets as an input. The rings are consumed exactly: 2 by Dhat^+, 1
// by a and b, 1 by the force stencil's gathers at n+t, n+x (and by the
// staples' n-x, n-t). The halo exchange stays outside.
//
// What bounds it on the card: latency, as K7 (one block reads ~46 KB and
// writes 4 KB). This file holds the entry, the launch and the global path's
// stage order; the force arithmetic of both paths is force_shared.cuh's, as
// K1's is. Where the block keeps
// its fields is chosen before the launch by K7's rule (ops/halo.halo_path):
//
// - shared: K1's no-solve kernel body with staples (force_shared_kernel,
//   HALO): the 104-byte store, the links and psi read from the planes 16
//   bytes a thread, four barriers; `blocks` blocks a shard, each holding its
//   interior rows and the 4 extended rows on either side;
// - global (a block no split holds): one thread block per shard, the planar
//   stages of stencil.cuh, b, chi', a and the plaquette angles in a scratch,
//   the plaquettes and the force by K1's global path's helpers
//   (plaq_pair_planar, force_pair_planar).
#include "force_shared.cuh"

namespace sm {

__global__ void __launch_bounds__(kThreads)
halo_force_global_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
                         const int* __restrict__ off_all, const float* __restrict__ psi_all,
                         float* __restrict__ FE_all, float* __restrict__ FO_all,
                         float* __restrict__ scratch, int Nxe, int Nthe, float m, float c,
                         float beta) {
  const Geo g{Nxe, Nthe, Nxe * Nthe};
  const int V = g.V2;
  const size_t blk = blockIdx.x;
  const float* ue = ue_all + blk * 4 * V;
  const float* uo = uo_all + blk * 4 * V;
  const float* psi = psi_all + blk * 4 * V;
  const int* off = off_all + blk * Nxe;
  float* bo = scratch + blk * 14 * V;  // (H_eo)^+ psi, odd
  float* chi = bo + 4 * V;             // Dhat^+ psi, even
  float* ao = bo + 8 * V;              // H_oe chi, odd
  float* se = bo + 12 * V;             // Im P at even sites
  float* so = bo + 13 * V;             // Im P at odd sites

  hop_stage_ext<float, true>(uo, ue, psi, off, 1, bo, nullptr, 0.f, 0.f, g);
  for (int s = threadIdx.x; s < V; s += blockDim.x) {
    const int x = s / Nthe;
    const int k = s - x * Nthe;
    plaq_pair_planar(ue, uo, s, neighbours(x, k, off[x], g), neighbours(x, k, off[x] ^ 1, g), V,
                     se, so);
  }
  __syncthreads();
  hop_stage_ext<float, true>(ue, uo, bo, off, 0, chi, psi, m, -c, g);
  __syncthreads();
  hop_stage_ext<float, false>(uo, ue, chi, off, 1, ao, nullptr, 0.f, 0.f, g);
  __syncthreads();

  const int Nx = Nxe - 2 * kHaloW, Nth = Nthe - 2 * kHaloW, Vl = Nx * Nth;
  float* FE = FE_all + blk * 2 * Vl;
  float* FO = FO_all + blk * 2 * Vl;
  for (int i = threadIdx.x; i < Vl; i += blockDim.x) {
    const int xl = i / Nth;
    const int x = xl + kHaloW, k = i - xl * Nth + kHaloW;
    force_pair_planar<true>(ue, uo, psi, chi, bo, ao, se, so, x * Nthe + k,
                            neighbours(x, k, off[x], g), neighbours(x, k, off[x] ^ 1, g), V,
                            2.0f * c, beta, FE, FO, i, Vl);
  }
}

}  // namespace sm

// ue, uo, psi: f32 [n_blocks, 2, 2, Nxe, Nthe]; off: int32 [n_blocks, Nxe]
// (alternating by row); FE, FO: f32 [n_blocks, 2, Nxe-8, Nthe-8]. path 0:
// the global scratch, f32 [n_blocks, 14 * Nxe * Nthe]; path 1: shared
// memory, `blocks` blocks a shard (a divisor of Nxe-8 whose rows, with 4
// rows on either side, hold at most 2048 sites and 220 KB), no scratch.
extern "C" int halo_force_launch(const void* ue, const void* uo, const void* off, const void* psi,
                                 void* FE, void* FO, void* scratch, int n_blocks, int Nxe,
                                 int Nthe, double m0, double beta, int path, int blocks,
                                 void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *ue_f = static_cast<const float*>(ue), *uo_f = static_cast<const float*>(uo);
  const float* psi_f = static_cast<const float*>(psi);
  const int* off_i = static_cast<const int*>(off);
  if (path == 0) {
    sm::halo_force_global_kernel<<<n_blocks, sm::kThreads, 0, s>>>(
        ue_f, uo_f, off_i, psi_f, static_cast<float*>(FE), static_cast<float*>(FO),
        static_cast<float*>(scratch), Nxe, Nthe, m, c, static_cast<float>(beta));
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 1) return static_cast<int>(cudaErrorInvalidValue);
  return sm::launch_shared<false, true, false, true>(
      ue_f, uo_f, nullptr, psi_f, nullptr, static_cast<float*>(FE), static_cast<float*>(FO),
      nullptr, nullptr, n_blocks, Nxe, Nthe, m, c, 0.f, static_cast<float>(beta), 0.0, 0, blocks,
      s, off_i);
}
