// K7: the per-shard (Dhat Dhat^+) apply on the width-4-extended block, with
// the local partials of the single-reduction CG's four inner products.
//
// Replaces schwingermodel_tpu/ops/pallas_halo.py:_halo_normal_kernel
// (halo_normal_fused). The contract is the Pallas kernel's: extended f32
// planes in (both parities' folded links, the spinor v, the even-parity row
// offsets from the global x), the cropped out = (Dhat Dhat^+) v back, and
// with dots the local [<r,r>, <d,Ad>, <Ad,Ad>, <r,Ad>] with d = crop(v),
// Ad = out and r the un-extended local residual. The halo exchange and the
// psum of the partials stay outside, so the kernel does not know which
// shard it serves. All four hops run on every site of the extended block
// with plain periodic wrap, as the Pallas kernel does; the last one only on
// the kept interior.
//
// What bounds it on the card: launch latency. One block moves ~60 KB and
// does ~1e6 flops; 128 blocks at C=32 on a 2x2 mesh are a few microseconds
// of memory traffic. Design: one thread block per (chain, shard), about one
// per SM at the demo mesh. The block's inputs and the intermediates w1, u
// (w2 reuses w1) are 20 planes of the extended block, 77 KB at 64x64 over
// 2x2: they stay in shared memory, so the three barriers between the
// dependent stages are the only synchronisation and device memory is read
// and written once. A block too large for shared memory (above 220 KB)
// reads its inputs from global memory and keeps w1 and u in a scratch the
// wrapper allocates. The partials are accumulated per thread in f64,
// reduced over the block and rounded once to f32.
#include "stencil.cuh"

namespace sm {

template <bool DOTS>
__global__ void __launch_bounds__(kThreads)
halo_normal_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
                   const int* __restrict__ off_all, const float* __restrict__ v_all,
                   const float* __restrict__ r_all, float* __restrict__ out_all,
                   float* __restrict__ dots_all, float* __restrict__ scratch, int Nxe, int Nthe,
                   float m, float c) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[33];
  const Geo g{Nxe, Nthe, Nxe * Nthe};
  const int V = g.V2;
  const size_t blk = blockIdx.x;
  const float* ue = ue_all + blk * 4 * V;
  const float* uo = uo_all + blk * 4 * V;
  const float* v = v_all + blk * 4 * V;
  const int* off = off_all + blk * Nxe;
  float* w;
  if (scratch == nullptr) {
    copy_in(smem, ue, 4 * V);
    copy_in(smem + 4 * V, uo, 4 * V);
    copy_in(smem + 8 * V, v, 4 * V);
    ue = smem;
    uo = smem + 4 * V;
    v = smem + 8 * V;
    w = smem + 12 * V;
    __syncthreads();
  } else {
    w = scratch + blk * 8 * V;
  }
  float* w1 = w;          // (H_eo)^+ v, then H_oe u
  float* u = w + 4 * V;   // Dhat^+ v

  hop_stage_ext<float, true>(uo, ue, v, off, 1, w1, nullptr, 0.f, 0.f, g);
  __syncthreads();
  hop_stage_ext<float, true>(ue, uo, w1, off, 0, u, v, m, -c, g);
  __syncthreads();
  hop_stage_ext<float, false>(uo, ue, u, off, 1, w1, nullptr, 0.f, 0.f, g);
  __syncthreads();

  // Dhat u on the kept interior, with the partials
  const int Nx = Nxe - 2 * kHaloW, Nth = Nthe - 2 * kHaloW, Vl = Nx * Nth;
  float* out = out_all + blk * 4 * Vl;
  const float* r = DOTS ? r_all + blk * 4 * Vl : nullptr;
  double rr = 0.0, dAd = 0.0, AdAd = 0.0, rAd = 0.0;
  for (int i = threadIdx.x; i < Vl; i += blockDim.x) {
    const int xl = i / Nth;
    const int x = xl + kHaloW, k = i - xl * Nth + kHaloW;
    const int s = x * Nthe + k;
    const Nbr n = neighbours(x, k, off[x], g);
    Cx<float> h0, h1;
    hop_site<float, false>(ue, uo, w1, s, n, V, h0, h1);
    const Cx<float> u0 = ld(u, 0, s, V), u1 = ld(u, 1, s, V);
    const float o[4] = {m * u0.re + (-c) * h0.re, m * u0.im + (-c) * h0.im,
                        m * u1.re + (-c) * h1.re, m * u1.im + (-c) * h1.im};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      out[p * Vl + i] = o[p];
      if (DOTS) {
        const double Ad = o[p], d = v[p * V + s], rp = r[p * Vl + i];
        rr += rp * rp;
        dAd += d * Ad;
        AdAd += Ad * Ad;
        rAd += rp * Ad;
      }
    }
  }
  if (DOTS) {
    rr = block_sum(rr, sh);
    dAd = block_sum(dAd, sh);
    AdAd = block_sum(AdAd, sh);
    rAd = block_sum(rAd, sh);
    if (threadIdx.x == 0) {
      float* dots = dots_all + blk * 4;
      dots[0] = static_cast<float>(rr);
      dots[1] = static_cast<float>(dAd);
      dots[2] = static_cast<float>(AdAd);
      dots[3] = static_cast<float>(rAd);
    }
  }
}

template <bool DOTS>
int launch_normal(const void* ue, const void* uo, const void* off, const void* v, const void* r,
                  void* out, void* dots, void* scratch, int n_blocks, int Nxe, int Nthe, float m,
                  float c, cudaStream_t stream) {
  size_t shared = 0;
  if (scratch == nullptr) {
    shared = sizeof(float) * 20 * Nxe * Nthe;
    if (shared > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        halo_normal_kernel<DOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedMax);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  halo_normal_kernel<DOTS><<<n_blocks, kThreads, shared, stream>>>(
      static_cast<const float*>(ue), static_cast<const float*>(uo),
      static_cast<const int*>(off), static_cast<const float*>(v), static_cast<const float*>(r),
      static_cast<float*>(out), static_cast<float*>(dots), static_cast<float*>(scratch), Nxe,
      Nthe, m, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm

// ue, uo, v: f32 [n_blocks, 2, 2, Nxe, Nthe]; off: int32 [n_blocks, Nxe];
// out: f32 [n_blocks, 2, 2, Nxe-8, Nthe-8]. with_dots also reads r (the
// shape of out) and writes dots f32 [n_blocks, 4]. scratch: null to keep
// the block in shared memory (20 * Nxe * Nthe floats, at most 220 KB),
// else f32 [n_blocks, 8 * Nxe * Nthe].
extern "C" int halo_normal_launch(const void* ue, const void* uo, const void* off, const void* v,
                                  const void* r, void* out, void* dots, void* scratch,
                                  int n_blocks, int Nxe, int Nthe, double m0, int with_dots,
                                  void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dots)
    return sm::launch_normal<true>(ue, uo, off, v, r, out, dots, scratch, n_blocks, Nxe, Nthe, m,
                                   c, s);
  return sm::launch_normal<false>(ue, uo, off, v, r, out, dots, scratch, n_blocks, Nxe, Nthe, m, c,
                                  s);
}
