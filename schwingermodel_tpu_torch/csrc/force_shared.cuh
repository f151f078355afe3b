// K1's force stages on one block's shared memory, for K1 (force_step.cu),
// K5 (ratio_force.cu) and K8 (halo_force.cu): one kernel body, several
// blocks a chain without the solve, each block holding its rows between
// kHaloW rows of its neighbours' on either side, computed again (see
// force_step.cu); and the force at a site pair on the planar layout, for
// K1's and K8's global paths.
//
// K8's variant (HALO) is K1 without the solve, with staples, on one shard's
// extended block: the links and psi read from its planes, the row offsets
// from its rows' offsets, the rows split as K1's without wrap (the extended
// rows are the halo), the force written on the cropped interior.
//
// K5's variant (RATIO) folds the Hasenbusch ratio force's two bilinears into
// one: the force stencil f(x, y) is real-linear in y and H_oe is linear, so
//     2 c0 f(psi (+) b, chi' (+) H_oe chi') - 2 c1 f(psi (+) b, phi2 (+) H_oe phi2)
//   = 2 f(psi (+) b, Y (+) H_oe Y),  Y = c0 chi' - c1 phi2,
// and K5 is K1 without the solve, with staples, whose chi' stage writes Y
// (phi2 read from global memory at the block's sites, halo rows included)
// and whose force takes 2 for 2c. The same store, 104 bytes a site, and the
// same blocks a chain; two bilinears kept apart would need six spinors, 136
// bytes a site, more than one block holds at 64x64.
#pragma once

#include "shared_stencil.cuh"

namespace sm {

// The force at one even and one odd site of the shared layout: the fermion
// force of fermion_force_site and, with_gauge, the staples from the
// plaquette angles (Im P even, Im P odd) of each site.
template <bool WITH_GAUGE>
__device__ __forceinline__ void force_pair_shared(const float2* ue, const float2* uo,
                                                  const float4* P, const float4* B,
                                                  const float4* X, const float4* A,
                                                  const float2* plaq, int s, const Nbr& ne,
                                                  const Nbr& no, int V2, float two_c,
                                                  float beta, float fe[2], float fo[2]) {
  float f0, f1;
  // even sites: x = psi, y = chi'; the odd operands are b and a
  {
    const float4 xp = P[s], yp = X[s], xt = B[ne.pt], yt = A[ne.pt], xx = B[ne.px],
                 yx = A[ne.px];
    fermion_force_ops(cx(ue[s]), cx(ue[V2 + s]), lo(xp), hi(xp), lo(yp), hi(yp), lo(xt),
                      hi(xt), lo(yt), hi(yt), lo(xx), hi(xx), lo(yx), hi(yx), f0, f1);
    if (WITH_GAUGE) {
      const float se = plaq[s].x;
      fe[0] = two_c * f0 + (-beta * (se - plaq[ne.mx].y));
      fe[1] = two_c * f1 + beta * (se - plaq[ne.mt].y);
    } else {
      fe[0] = two_c * f0;
      fe[1] = two_c * f1;
    }
  }
  // odd sites: x = b, y = a; the even operands are psi and chi'
  {
    const float4 xp = B[s], yp = A[s], xt = P[no.pt], yt = X[no.pt], xx = P[no.px],
                 yx = X[no.px];
    fermion_force_ops(cx(uo[s]), cx(uo[V2 + s]), lo(xp), hi(xp), lo(yp), hi(yp), lo(xt),
                      hi(xt), lo(yt), hi(yt), lo(xx), hi(xx), lo(yx), hi(yx), f0, f1);
    if (WITH_GAUGE) {
      const float so = plaq[s].y;
      fo[0] = two_c * f0 + (-beta * (so - plaq[no.mx].x));
      fo[1] = two_c * f1 + beta * (so - plaq[no.mt].x);
    } else {
      fo[0] = two_c * f0;
      fo[1] = two_c * f1;
    }
  }
}

// The same on the planar layout of stencil.cuh, for the global paths of K1
// (force_step.cu) and K8 (halo_force.cu): psi and chi' at even sites, b and
// a at odd ones, with_gauge the plaquette angles se (even) and so (odd); ne
// and no the neighbours of site s at either parity. The force at site s is
// written to FE[i], FE[Vo + i] and FO[i], FO[Vo + i].
template <bool WITH_GAUGE>
__device__ __forceinline__ void force_pair_planar(const float* ue, const float* uo,
                                                  const float* psi, const float* chi,
                                                  const float* bo, const float* ao,
                                                  const float* se, const float* so, int s,
                                                  const Nbr& ne, const Nbr& no, int V2,
                                                  float two_c, float beta, float* FE, float* FO,
                                                  int i, int Vo) {
  float f0, f1;
  // even sites: x = psi, y = chi'; the odd operands are b and a
  fermion_force_site(ue, psi, chi, bo, ao, s, ne, V2, f0, f1);
  if (WITH_GAUGE) {
    FE[i] = two_c * f0 + (-beta * (se[s] - so[ne.mx]));
    FE[Vo + i] = two_c * f1 + beta * (se[s] - so[ne.mt]);
  } else {
    FE[i] = two_c * f0;
    FE[Vo + i] = two_c * f1;
  }
  // odd sites: x = b, y = a; the even operands are psi and chi'
  fermion_force_site(uo, bo, ao, psi, chi, s, no, V2, f0, f1);
  if (WITH_GAUGE) {
    FO[i] = two_c * f0 + (-beta * (so[s] - se[no.mx]));
    FO[Vo + i] = two_c * f1 + beta * (so[s] - se[no.mt]);
  } else {
    FO[i] = two_c * f0;
    FO[Vo + i] = two_c * f1;
  }
}

// Im P(n) = Im u0(n) u1(n+t) conj(u0(n+x) u1(n)), anchored at the even and at
// the odd site s of the planar layout, into se[s] and so[s].
__device__ __forceinline__ void plaq_pair_planar(const float* ue, const float* uo, int s,
                                                 const Nbr& ne, const Nbr& no, int V2,
                                                 float* se, float* so) {
  se[s] = plaq_im(ld(ue, 0, s, V2), ld(uo, 1, ne.pt, V2), ld(uo, 0, ne.px, V2),
                  ld(ue, 1, s, V2));
  so[s] = plaq_im(ld(uo, 0, s, V2), ld(ue, 1, no.pt, V2), ld(ue, 0, no.px, V2),
                  ld(uo, 1, s, V2));
}

// K1 on the shared path: `blocks` blocks a chain (1 with the solve), block
// `rank` owning the rows [rank * rows, (rank + 1) * rows) and holding them
// between kHaloW rows on either side when blocks > 1. Shared memory: the CG
// store's links and four spinors (psi, b, chi', a in d's, r's and the two
// temporaries' places), with_gauge the plaquette angles of each site after
// them. RATIO (K5): psi in x0_all, phi2 in phi_all, c = c0; the chi' stage
// ends in Y = c0 chi' - c1 phi2, a = H_oe Y, and the force takes 2 for 2c;
// iters_out and conv_out are not written. HALO (K8): one entry of a shard's
// width-kHaloW-extended block [Nx, Nth] a chain; thE and thO are its
// extended folded links (planar f32 [2][2][Nx][Nth], read as they are),
// x0_all its extended psi, off_all its rows' even-parity offsets
// (alternating, so the slab's first row gives them all); the blocks split
// the Nx - 2 kHaloW interior rows, each holding the kHaloW extended rows on
// either side, which lie inside the block: no wrap of the rows. The force
// is written on the interior, cropped in both directions, [2][Nx-8][Nth-8]
// an entry; iters_out and conv_out are not written.
template <bool WITH_SOLVE, bool WITH_GAUGE, bool RATIO = false, bool HALO = false>
__global__ void __launch_bounds__(kThreads)
force_shared_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                    const float* __restrict__ phi_all, const float* __restrict__ x0_all,
                    float* __restrict__ psi_all, float* __restrict__ FE_all,
                    float* __restrict__ FO_all, int* __restrict__ iters_out,
                    unsigned char* __restrict__ conv_out, const int* __restrict__ off_all,
                    int Nx, int Nth, float m, float c, float c1, float beta, double tol,
                    int max_iter, int blocks) {
  static_assert(!RATIO || (!WITH_SOLVE && WITH_GAUGE),
                "K5 is K1 without the solve, with staples");
  static_assert(!HALO || (!WITH_SOLVE && WITH_GAUGE && !RATIO),
                "K8 is K1 without the solve, with staples");
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[2 * (kThreads / 32)];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int ch = blockIdx.x / blocks, rank = blockIdx.x - ch * blocks;
  // HALO: the interior rows are split, and every block holds the extended
  // rows on either side of its own
  const int rows = (HALO ? Nx - 2 * kHaloW : Nx) / blocks;
  const int halo = HALO || blocks > 1 ? kHaloW : 0;
  // the block's rows: row first + xl (global, or of the extended block) at
  // local row xl
  const int first = HALO ? rank * rows : rank * rows - halo;
  const Geo lg{rows + 2 * halo, Nth, (rows + 2 * halo) * Nth};
  const int par = HALO ? off_all[(size_t)ch * Nx + first] : first & 1;
  CgShared S = cg_shared(smem, sh, lg, m, c);
  float4 *P = S.d, *B = S.r, *X = S.t1, *A = S.t2;
  const float2* plaq = reinterpret_cast<float2*>(smem + 24 * lg.V2);
  if (HALO) {
    const size_t blk = (size_t)ch * 4 * V2;
    load_links_rows(thE + blk, S.ue, lg, (size_t)first * Nth, V2);
    load_links_rows(thO + blk, S.uo, lg, (size_t)first * Nth, V2);
  } else {
    make_links_rows(thE + (size_t)ch * 2 * V2, 0, S.ue, lg, first, g);
    make_links_rows(thO + (size_t)ch * 2 * V2, 1, S.uo, lg, first, g);
  }
  const float* x0 = x0_all + (size_t)ch * 4 * V2;
  if (HALO) {
    load_spinor_rows(x0, P, lg, (size_t)first * Nth, V2);
  } else if (WITH_SOLVE) {
    // one block: the links are visible after the CG's first barrier
    const CgOut o = S.solve(phi_all + (size_t)ch * 4 * V2, x0, tol, max_iter);
    S.write_x(psi_all + (size_t)ch * 4 * V2);
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j)
      if (S.mine(j))
        P[threadIdx.x + j * kThreads] = make_float4(S.x[j][0], S.x[j][1], S.x[j][2], S.x[j][3]);
    if (threadIdx.x == 0) {
      iters_out[ch] = o.iters;
      conv_out[ch] = o.rho < static_cast<float>(tol * tol) * o.bnorm2;
    }
  } else {
    for (int s = threadIdx.x; s < lg.V2; s += kThreads) {
      const int xl = s / Nth;
      const int gs = ((first + xl) % Nx + Nx) % Nx * Nth + (s - xl * Nth);
      P[s] = make_float4(x0[gs], x0[V2 + gs], x0[2 * V2 + gs], x0[3 * V2 + gs]);
    }
    if (!RATIO && rank == 0 && threadIdx.x == 0) {
      iters_out[ch] = 0;
      conv_out[ch] = 1;
    }
  }
  __syncthreads();
  S.own.stage<true, false>(S.uo, S.ue, P, 1 ^ par, B, nullptr, 0.f, 0.f, lg);  // b
  __syncthreads();
  S.own.stage<true, true>(S.ue, S.uo, B, par, X, P, m, -c, lg);  // chi'
  if (RATIO) {
    // Y = c0 chi' - c1 phi2 at the thread's own sites, which it just wrote
    const float* phi2 = phi_all + (size_t)ch * 4 * V2;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < lg.V2) {
        const int xl = S.own.sxk[j] >> 16;
        const int gs = ((first + xl) % Nx + Nx) % Nx * Nth + (S.own.sxk[j] & 0xffff);
        const float4 xs = X[s];
        const float* q = phi2 + gs;
        X[s] = make_float4(c * xs.x - c1 * q[0], c * xs.y - c1 * q[V2],
                           c * xs.z - c1 * q[2 * V2], c * xs.w - c1 * q[3 * V2]);
      }
    }
  }
  if (WITH_GAUGE) {
    float2* pl = reinterpret_cast<float2*>(smem + 24 * lg.V2);
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < lg.V2) {
        const Nbr ne = S.own.nbrs(j, par, lg), no = S.own.nbrs(j, 1 ^ par, lg);
        const float2 *ue = S.ue, *uo = S.uo;
        pl[s] = make_float2(
            plaq_im(cx(ue[s]), cx(uo[lg.V2 + ne.pt]), cx(uo[ne.px]), cx(ue[lg.V2 + s])),
            plaq_im(cx(uo[s]), cx(ue[lg.V2 + no.pt]), cx(ue[no.px]), cx(uo[lg.V2 + s])));
      }
    }
  }
  __syncthreads();
  S.own.stage<false, false>(S.uo, S.ue, X, 1 ^ par, A, nullptr, 0.f, 0.f, lg);  // a (of Y)
  __syncthreads();

  // the force's sites: the chain's, or the entry's interior [Nx-8][Nth-8]
  const int crop = HALO ? kHaloW : 0;
  const int Vf = (Nx - 2 * crop) * (Nth - 2 * crop);
  float* FE = FE_all + (size_t)ch * 2 * Vf;
  float* FO = FO_all + (size_t)ch * 2 * Vf;
  const float two_c = RATIO ? 2.0f : 2.0f * c;
#pragma unroll
  for (int j = 0; j < kOwnSites; ++j) {
    const int s = threadIdx.x + j * kThreads;
    const int xl = S.own.sxk[j] >> 16, k = S.own.sxk[j] & 0xffff;
    if (s < lg.V2 && xl >= halo && xl < halo + rows && k >= crop && k < Nth - crop) {
      float fe[2], fo[2];
      force_pair_shared<WITH_GAUGE>(S.ue, S.uo, P, B, X, A, plaq, s, S.own.nbrs(j, par, lg),
                                    S.own.nbrs(j, 1 ^ par, lg), lg.V2, two_c, beta, fe, fo);
      const int gs = HALO ? (first + xl - crop) * (Nth - 2 * crop) + (k - crop) : s + first * Nth;
      FE[gs] = fe[0];
      FE[Vf + gs] = fe[1];
      FO[gs] = fo[0];
      FO[Vf + gs] = fo[1];
    }
  }
}

// Shared memory of the shared path a site: the CG store, and with_gauge the
// plaquette angles.
constexpr int force_shared_bytes(bool with_gauge) {
  return kCgSharedBytes + (with_gauge ? 8 : 0);
}

// The shared path's launch: `blocks` blocks a chain (1 with the solve; else
// a divisor of Nx whose rows, with kHaloW rows on either side, hold at most
// 2048 sites; HALO: of the Nx - 2 kHaloW interior rows, with the kHaloW
// extended rows on either side for every count). Returns
// cudaGetLastError().
template <bool S, bool G, bool R = false, bool H = false>
int launch_shared(const float* thE, const float* thO, const float* phi, const float* x0,
                  float* psi, float* FE, float* FO, int* iters, unsigned char* conv, int C,
                  int Nx, int Nth, float m, float c, float c1, float beta, double tol,
                  int max_iter, int blocks, cudaStream_t stream, const int* off = nullptr) {
  const int span = H ? Nx - 2 * kHaloW : Nx;
  const int rows = blocks > 0 ? span / blocks : 0;
  const size_t sites = static_cast<size_t>(rows + (H || blocks > 1 ? 2 * kHaloW : 0)) * Nth;
  const size_t bytes = force_shared_bytes(G) * sites;
  if (blocks < 1 || (S && blocks != 1) || span % blocks != 0 || sites > kOwnSites * kThreads ||
      bytes > kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      force_shared_kernel<S, G, R, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  force_shared_kernel<S, G, R, H><<<C * blocks, kThreads, bytes, stream>>>(
      thE, thO, phi, x0, psi, FE, FO, iters, conv, off, Nx, Nth, m, c, c1, beta, tol, max_iter,
      blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm
