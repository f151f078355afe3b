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
// shard it serves. All four hops run with plain periodic wrap, as the
// Pallas kernel does; the last one only on the kept interior.
//
// What bounds it on the card: latency. A shard's block moves ~60 KB and
// does ~1e6 flops: 128 blocks at C=32 on a 2x2 mesh are 2.4 us of memory
// traffic, and what a block waits for is its loads, its barriers and the
// dependent stages between them. Where it keeps its fields is chosen by
// the block's size and the number of blocks before the launch
// (ops/halo.halo_path, K1's rule without the solve):
//
// - shared: the site-major store of shared_stencil.cuh (links of both
//   parities one float2 a site, v, w1 and u one float4 a site: 80 bytes a
//   site, 77 KB at 64x64 over 2x2), the planes read 16 bytes a thread, the
//   stages by OwnSites::stage, four barriers, and the four partials reduced
//   with one more (block_sum4). n blocks a shard (n from the number of
//   blocks, to fill the card's multiprocessors where one block a shard
//   leaves most of them idle, or to hold a block one block cannot, e.g.
//   128x128 over 2x2 on 8): each holds its Nx / n interior rows and the
//   kHaloW rows of the extended block on either side, which lie inside the
//   extended block. Each hop spoils one row at either edge of the slab, so
//   the four hops leave the interior rows exact, as the crop rests on. The
//   row offsets alternate, so the offset of the slab's first row is all the
//   stages read. With n > 1 each block writes its f64 partials, and the
//   shard's last block to finish (a ticket counter a shard) adds them in
//   rank order and rounds once to f32, in the same launch;
// - global (a block no split holds): one thread block per shard, the
//   planar stages of stencil.cuh over the global inputs, w1 and u in a
//   scratch the wrapper allocates.
//
// The partials are accumulated per thread in f64, reduced over the block
// and over a shard's blocks in a fixed order with no atomics on them (the
// split path's ticket picks which block adds, not the order), so two
// launches on the same inputs give the same bits, and rounded once to f32. out is computed per site in hop_site's order on both
// paths.
#include "shared_stencil.cuh"

namespace sm {

// Bytes a site of the shared path: links 32, v, w1, u 48.
constexpr int kNormalSharedBytes = 80;

template <bool DOTS>
__global__ void __launch_bounds__(kThreads)
halo_normal_shared_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
                          const int* __restrict__ off_all, const float* __restrict__ v_all,
                          const float* __restrict__ r_all, float* __restrict__ out_all,
                          float* __restrict__ dots_all, double* __restrict__ parts,
                          unsigned* __restrict__ tickets, int Nxe, int Nthe, float m, float c,
                          int blocks) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[4 * (kThreads / 32)];
  const int V = Nxe * Nthe;
  const int e = blockIdx.x / blocks, rank = blockIdx.x - e * blocks;
  const int Nx = Nxe - 2 * kHaloW, Nth = Nthe - 2 * kHaloW, Vl = Nx * Nth;
  // the slab: extended rows [first, first + rows + 2 kHaloW)
  const int rows = Nx / blocks, first = rank * rows;
  const Geo lg{rows + 2 * kHaloW, Nthe, (rows + 2 * kHaloW) * Nthe};
  const int par = off_all[static_cast<size_t>(e) * Nxe + first];
  float2* ue = reinterpret_cast<float2*>(smem);
  float2* uo = ue + 2 * lg.V2;
  float4* v = reinterpret_cast<float4*>(smem + 8 * lg.V2);
  float4* w1 = v + lg.V2;  // (H_eo)^+ v, then H_oe u
  float4* u = w1 + lg.V2;  // Dhat^+ v
  const size_t site0 = static_cast<size_t>(first) * Nthe;
  const size_t blk = static_cast<size_t>(e) * 4 * V;
  load_links_rows(ue_all + blk, ue, lg, site0, V);
  load_links_rows(uo_all + blk, uo, lg, site0, V);
  load_spinor_rows(v_all + blk, v, lg, site0, V);
  OwnSites own;
  own.init(lg);
  __syncthreads();
  own.stage<true, false>(uo, ue, v, 1 ^ par, w1, nullptr, 0.f, 0.f, lg);
  __syncthreads();
  own.stage<true, true>(ue, uo, w1, par, u, v, m, -c, lg);
  __syncthreads();
  own.stage<false, false>(uo, ue, u, 1 ^ par, w1, nullptr, 0.f, 0.f, lg);
  __syncthreads();

  // Dhat u on the slab's interior sites, with the partials
  float* out = out_all + static_cast<size_t>(e) * 4 * Vl;
  const float* r = DOTS ? r_all + static_cast<size_t>(e) * 4 * Vl : nullptr;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};  // rr, dAd, AdAd, rAd
#pragma unroll
  for (int j = 0; j < kOwnSites; ++j) {
    const int s = threadIdx.x + j * kThreads;
    const int xl = own.sxk[j] >> 16, k = own.sxk[j] & 0xffff;
    if (s >= lg.V2 || xl < kHaloW || xl >= kHaloW + rows || k < kHaloW || k >= kHaloW + Nth)
      continue;
    Cx<float> h0, h1;
    hop_site_shared<false>(ue, uo, w1, s, own.nbrs(j, par, lg), lg.V2, h0, h1);
    const float4 us = u[s];
    const float o[4] = {m * us.x + (-c) * h0.re, m * us.y + (-c) * h0.im,
                        m * us.z + (-c) * h1.re, m * us.w + (-c) * h1.im};
    const int i = (first + xl - kHaloW) * Nth + (k - kHaloW);
    const float4 ds = v[s];
    const float d[4] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      out[p * Vl + i] = o[p];
      if (DOTS) {
        const double Ad = o[p], rp = r[p * Vl + i];
        acc[0] += rp * rp;
        acc[1] += d[p] * Ad;
        acc[2] += Ad * Ad;
        acc[3] += rp * Ad;
      }
    }
  }
  if (DOTS) {
    block_sum4(acc, sh);
    if (threadIdx.x == 0) {
      float* dots = dots_all + static_cast<size_t>(e) * 4;
      if (blocks == 1) {
        for (int q = 0; q < 4; ++q) dots[q] = static_cast<float>(acc[q]);
      } else {
        // each block writes its f64 partials; the shard's last block to
        // finish adds them in rank order and rounds once, and resets the
        // shard's ticket for the next launch
        double* part = parts + static_cast<size_t>(e) * blocks * 4;
        for (int q = 0; q < 4; ++q) part[4 * rank + q] = acc[q];
        __threadfence();
        if (atomicAdd(tickets + e, 1u) == static_cast<unsigned>(blocks - 1)) {
          __threadfence();
          for (int q = 0; q < 4; ++q) {
            double sum = __ldcg(part + q);
            for (int b = 1; b < blocks; ++b) sum += __ldcg(part + 4 * b + q);
            dots[q] = static_cast<float>(sum);
          }
          tickets[e] = 0;
        }
      }
    }
  }
}

template <bool DOTS>
__global__ void __launch_bounds__(kThreads)
halo_normal_global_kernel(const float* __restrict__ ue_all, const float* __restrict__ uo_all,
                          const int* __restrict__ off_all, const float* __restrict__ v_all,
                          const float* __restrict__ r_all, float* __restrict__ out_all,
                          float* __restrict__ dots_all, float* __restrict__ scratch, int Nxe,
                          int Nthe, float m, float c) {
  __shared__ double sh[33];
  const Geo g{Nxe, Nthe, Nxe * Nthe};
  const int V = g.V2;
  const size_t blk = blockIdx.x;
  const float* ue = ue_all + blk * 4 * V;
  const float* uo = uo_all + blk * 4 * V;
  const float* v = v_all + blk * 4 * V;
  const int* off = off_all + blk * Nxe;
  float* w1 = scratch + blk * 8 * V;  // (H_eo)^+ v, then H_oe u
  float* u = w1 + 4 * V;              // Dhat^+ v

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
                  float c, int path, int blocks, cudaStream_t stream) {
  const float *ue_f = static_cast<const float*>(ue), *uo_f = static_cast<const float*>(uo);
  const float *v_f = static_cast<const float*>(v), *r_f = static_cast<const float*>(r);
  const int* off_i = static_cast<const int*>(off);
  if (path == 0) {
    halo_normal_global_kernel<DOTS><<<n_blocks, kThreads, 0, stream>>>(
        ue_f, uo_f, off_i, v_f, r_f, static_cast<float*>(out), static_cast<float*>(dots),
        static_cast<float*>(scratch), Nxe, Nthe, m, c);
    return static_cast<int>(cudaGetLastError());
  }
  const int Nx = Nxe - 2 * kHaloW;
  const int rows = blocks > 0 ? Nx / blocks : 0;
  const size_t sites = static_cast<size_t>(rows + 2 * kHaloW) * Nthe;
  const size_t bytes = kNormalSharedBytes * sites;
  if (path != 1 || blocks < 1 || Nx % blocks != 0 || sites > kOwnSites * kThreads ||
      bytes > kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  // blocks > 1 with the dots: the scratch holds the blocks' f64 partials
  // [n_blocks][blocks][4], then a ticket a shard (zero between launches)
  double* parts = static_cast<double*>(scratch);
  if (DOTS && blocks > 1 && parts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  unsigned* tickets = parts == nullptr ? nullptr
                                       : reinterpret_cast<unsigned*>(
                                             parts + static_cast<size_t>(n_blocks) * blocks * 4);
  const cudaError_t e = cudaFuncSetAttribute(
      halo_normal_shared_kernel<DOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  halo_normal_shared_kernel<DOTS><<<n_blocks * blocks, kThreads, bytes, stream>>>(
      ue_f, uo_f, off_i, v_f, r_f, static_cast<float*>(out), static_cast<float*>(dots), parts,
      tickets, Nxe, Nthe, m, c, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm

// ue, uo, v: f32 [n_blocks, 2, 2, Nxe, Nthe]; off: int32 [n_blocks, Nxe]
// (alternating by row); out: f32 [n_blocks, 2, 2, Nxe-8, Nthe-8].
// with_dots also reads r (the shape of out) and writes dots: f32
// [n_blocks, 4]. path 0: the global scratch, f32 [n_blocks, 8 * Nxe * Nthe];
// path 1: shared memory, `blocks` blocks a shard (a divisor of Nxe-8 whose
// rows, with 4 rows on either side, hold at most 2048 sites and 220 KB);
// with the dots and `blocks` > 1 the scratch is f64 [n_blocks, blocks, 4]
// for the blocks' partials followed by uint32 [n_blocks] tickets, zero
// before the first launch (each launch leaves them zero), else null.
extern "C" int halo_normal_launch(const void* ue, const void* uo, const void* off, const void* v,
                                  const void* r, void* out, void* dots, void* scratch,
                                  int n_blocks, int Nxe, int Nthe, double m0, int with_dots,
                                  int path, int blocks, void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dots)
    return sm::launch_normal<true>(ue, uo, off, v, r, out, dots, scratch, n_blocks, Nxe, Nthe, m,
                                   c, path, blocks, s);
  return sm::launch_normal<false>(ue, uo, off, v, r, out, dots, scratch, n_blocks, Nxe, Nthe, m,
                                  c, path, blocks, s);
}
