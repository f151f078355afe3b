// The even-odd stencil on one block's shared memory, and the f32 CG that runs
// on it (K1, K2, K6, and K10 with its own operator; K3's f32 recursion uses
// the layout, the hop and the links; K5 and K8 run K1's force stages on it;
// K7 its stages, its loads of given planes and the four-value block sum; K9
// its rows' links in f64 and the warp partials' sum).
//
// Layout: site-major. A spinor is one float4 a site (spin 0 re, im, spin 1
// re, im), so a neighbour is one 16-byte load where the planar layout of
// stencil.cuh takes four; a parity's links are one float2 a site, u0 of the
// V2 sites, then u1. Ownership: thread tid owns the sites tid + j * kThreads,
// j < kOwnSites, so one block of 512 threads holds up to 2048 sites (64x64).
// The arithmetic of a hop is stencil.cuh's hop_bx and hop_combine on the same
// operands, so a stage here gives the bits of hop_stage.
#pragma once

#include "stencil.cuh"

namespace sm {

// Sites a thread owns: tid + j * kThreads, j < kOwnSites.
constexpr int kOwnSites = 4;

__device__ __forceinline__ Cx<float> lo(float4 v) { return {v.x, v.y}; }
__device__ __forceinline__ Cx<float> hi(float4 v) { return {v.z, v.w}; }
__device__ __forceinline__ Cx<float> cx(float2 v) { return {v.x, v.y}; }
__device__ __forceinline__ float4 f4(Cx<float> a, Cx<float> b) {
  return make_float4(a.re, a.im, b.re, b.im);
}

// hop_site on the shared layout: the arithmetic is hop_site's.
template <bool DAG>
__device__ __forceinline__ void hop_site_shared(const float2* Ut, const float2* Us,
                                                const float4* S, int s, const Nbr& n, int V2,
                                                Cx<float>& h0, Cx<float>& h1) {
  const float4 mx = S[n.mx];
  Cx<float> bx0, bx1;
  hop_bx<float, DAG>(cx(Us[V2 + n.mx]), lo(mx), hi(mx), bx0, bx1);
  const float4 pt = S[n.pt], px = S[n.px], mt = S[n.mt];
  hop_combine<float, DAG>(cx(Ut[s]), cx(Ut[V2 + s]), lo(pt), hi(pt), lo(px), hi(px),
                          cx(Us[n.mt]), lo(mt), hi(mt), bx0, bx1, h0, h1);
}

// One parity's links in shared memory for the rows xl < lg.Nx of a block:
// row xl holds global row (first + xl) mod g.Nx of the angles (first may be
// negative). V is float2 (the values of make_links<float>, K1 and K2) or
// double2 (those of make_links<double>, K9).
template <typename V>
__device__ __forceinline__ void make_links_rows(const float* __restrict__ th, int parity, V* u,
                                                const Geo& lg, int first, const Geo& g) {
  using T = decltype(V::x);
  for (int s = threadIdx.x; s < lg.V2; s += kThreads) {
    const int xl = s / lg.Nth;
    const int k = s - xl * lg.Nth;
    const int gx = ((first + xl) % g.Nx + g.Nx) % g.Nx;
    const bool flip = ((gx + parity) & 1) && (k == g.Nth - 1);
    for (int mu = 0; mu < 2; ++mu) {
      T sn, cs;
      sincos_t(static_cast<T>(th[mu * g.V2 + gx * g.Nth + k]), &sn, &cs);
      if (mu == 0 && flip) {
        sn = -sn;
        cs = -cs;
      }
      u[mu * lg.V2 + s] = V{cs, sn};
    }
  }
}

// The whole lattice's links of one parity.
__device__ __forceinline__ void make_links_shared(const float* __restrict__ th, int parity,
                                                  float2* u, const Geo& g) {
  make_links_rows(th, parity, u, g, 0, g);
}

// Whether planes of stride V holding a block's sites [site0, site0 + n) can
// be read 16 bytes at a time.
__device__ __forceinline__ bool quads(const float* p, size_t site0, int n, int V) {
  return ((site0 | static_cast<size_t>(n) | static_cast<size_t>(V)) & 3) == 0 &&
         (reinterpret_cast<size_t>(p) & 15) == 0;
}

// One parity's given links, planar [2(dir)][2(re/im)][V] in global memory
// (stencil.cuh's layout, as make_links<float> writes it), sites [site0,
// site0 + lg.V2) of it into the shared layout of a block of geometry lg:
// the values as they are, nothing built. Four sites a thread where the
// planes allow.
__device__ __forceinline__ void load_links_rows(const float* __restrict__ pl, float2* u,
                                                const Geo& lg, size_t site0, int V) {
  const int n = lg.V2;
  if (quads(pl, site0, n, V)) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      for (int mu = 0; mu < 2; ++mu) {
        const float4 re = reinterpret_cast<const float4*>(pl + (2 * mu) * V + site0)[i];
        const float4 im = reinterpret_cast<const float4*>(pl + (2 * mu + 1) * V + site0)[i];
        float4* d = reinterpret_cast<float4*>(u + mu * n + 4 * i);
        d[0] = make_float4(re.x, im.x, re.y, im.y);
        d[1] = make_float4(re.z, im.z, re.w, im.w);
      }
    return;
  }
  for (int s = threadIdx.x; s < n; s += kThreads)
    for (int mu = 0; mu < 2; ++mu)
      u[mu * n + s] =
          make_float2(pl[(2 * mu) * V + site0 + s], pl[(2 * mu + 1) * V + site0 + s]);
}

// The whole lattice's given links of one parity.
__device__ __forceinline__ void load_links_shared(const float* __restrict__ pl, float2* u,
                                                  const Geo& g) {
  load_links_rows(pl, u, g, 0, g.V2);
}

// A planar spinor [4][V] in global memory, sites [site0, site0 + lg.V2) of
// it into the shared layout (one float4 a site). Four sites a thread where
// the planes allow.
__device__ __forceinline__ void load_spinor_rows(const float* __restrict__ p, float4* S,
                                                 const Geo& lg, size_t site0, int V) {
  const int n = lg.V2;
  if (quads(p, site0, n, V)) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      float4 q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = reinterpret_cast<const float4*>(p + c * V + site0)[i];
      S[4 * i] = make_float4(q[0].x, q[1].x, q[2].x, q[3].x);
      S[4 * i + 1] = make_float4(q[0].y, q[1].y, q[2].y, q[3].y);
      S[4 * i + 2] = make_float4(q[0].z, q[1].z, q[2].z, q[3].z);
      S[4 * i + 3] = make_float4(q[0].w, q[1].w, q[2].w, q[3].w);
    }
    return;
  }
  for (int s = threadIdx.x; s < n; s += kThreads)
    S[s] = make_float4(p[site0 + s], p[V + site0 + s], p[2 * V + site0 + s],
                       p[3 * V + site0 + s]);
}

// The sites a thread owns in a block's geometry g, and the stencil stage on
// them.
struct OwnSites {
  int sxk[kOwnSites];  // row << 16 | packed column of each own site

  __device__ __forceinline__ void init(const Geo& g) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      const int sx = s / g.Nth;
      sxk[j] = (sx << 16) | (s - sx * g.Nth);
    }
  }

  // neighbours of own site j; tgt_parity is the target's parity relative to
  // row 0 of the block
  __device__ __forceinline__ Nbr nbrs(int j, int tgt_parity, const Geo& g) const {
    const int sx = sxk[j] >> 16;
    return neighbours(sx, sxk[j] & 0xffff, (sx + tgt_parity) & 1, g);
  }

  // out = hop(S) at the thread's sites, or a*v + b*hop(S): hop_stage on the
  // shared layout
  template <bool DAG, bool AXPBY>
  __device__ __forceinline__ void stage(const float2* Ut, const float2* Us, const float4* S,
                                        int tgt_parity, float4* out, const float4* v, float a,
                                        float bb, const Geo& g) const {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
        Cx<float> h0, h1;
        hop_site_shared<DAG>(Ut, Us, S, s, nbrs(j, tgt_parity, g), g.V2, h0, h1);
        if (AXPBY) {
          const float4 vs = v[s];
          h0 = axpby(a, lo(vs), bb, h0);
          h1 = axpby(a, hi(vs), bb, h1);
        }
        out[s] = f4(h0, h1);
      }
    }
  }
};

// The kThreads / 32 warp partials s[] added in the order of block_sum's
// second shuffle tree (partial w with w + 8, then + 4, + 2, + 1).
__device__ __forceinline__ double warp_partials_sum(const double* s) {
  static_assert(kThreads / 32 == 16, "the tree below adds 16 warp partials");
  // written out: as an array in a loop the tree went to local memory
  const double a0 = s[0] + s[8], a1 = s[1] + s[9], a2 = s[2] + s[10], a3 = s[3] + s[11];
  const double a4 = s[4] + s[12], a5 = s[5] + s[13], a6 = s[6] + s[14], a7 = s[7] + s[15];
  const double b0 = a0 + a4, b1 = a1 + a5, b2 = a2 + a6, b3 = a3 + a7;
  return (b0 + b2) + (b1 + b3);
}

// block_sum's result with one barrier (K1, K2): every warp writes its
// partial, one __syncthreads(), and every thread adds the kThreads / 32
// partials by warp_partials_sum, so the sum has block_sum's bits and every
// thread holds them. Slots alternate between two sets as in BlockSum.
struct BlockSumTree {
  double* sh;  // 2 * (kThreads / 32) doubles of shared memory
  int set;
  __device__ __forceinline__ double operator()(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    double* slot = sh + set * (kThreads / 32);
    set ^= 1;
    if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
    __syncthreads();
    return warp_partials_sum(slot);
  }
};

// Four block sums with one barrier (K7's CG partials): each value as
// BlockSumTree adds it, the four warp trees side by side; the sums are
// returned to every thread. Once a launch: the slots are not reused.
__device__ __forceinline__ void block_sum4(double (&v)[4], double* sh /* 4 * 16 */) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_down_sync(0xffffffffu, v[q], o);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) sh[q * (kThreads / 32) + (threadIdx.x >> 5)] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = warp_partials_sum(sh + q * (kThreads / 32));
}

// The f32 CG of cg_f32_op (stencil.cuh), with or without its guards, on one
// block's shared memory: both parities' links, d, r and two stencil
// temporaries, 96 bytes a site, x (f32) of the thread's own sites in
// registers. Ad takes the
// second temporary's place: the fourth stage reads that temporary only at the
// thread's own site, and forms the <d, Ad> partial there. 6 barriers an
// iteration (4 stages, 2 sums). A thread adds its products component by
// component over its sites, as block_dot walks the planar index, and the sums
// are block_sum's: where the thread's sites are the planar indices tid +
// k * 512 (V2 a multiple of 512, e.g. 32x32 and 64x64) every dot, and so x,
// the iterations and the flags, has the bits of cg_f32.
struct CgShared {
  float2 *ue, *uo;          // links of 2 V2 float2 each
  float4 *d, *r, *t1, *t2;  // spinors of V2 float4 each
  Geo g;
  float m, c;
  BlockSumTree sum;
  OwnSites own;
  float x[kOwnSites][4];

  __device__ __forceinline__ bool mine(int j) const {
    return threadIdx.x + j * kThreads < g.V2;
  }

  // Re<a, b> over the thread's sites, component-major, summed over the block
  __device__ __forceinline__ float dot(const float (&a)[kOwnSites][4],
                                       const float (&b)[kOwnSites][4]) {
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < kOwnSites; ++j)
        if (mine(j)) acc += static_cast<double>(a[j][q]) * static_cast<double>(b[j][q]);
    }
    return static_cast<float>(sum(acc));
  }

  // Ad = (Dhat Dhat^+) d at the thread's sites into a (and t2); returns
  // <d, Ad>. The first barrier makes the d written just before visible.
  __device__ __forceinline__ float apply(float (&a)[kOwnSites][4]) {
    __syncthreads();
    own.stage<true, false>(uo, ue, d, 1, t1, nullptr, 0.f, 0.f, g);  // (H_eo)^+ d
    __syncthreads();
    own.stage<true, true>(ue, uo, t1, 0, t2, d, m, -c, g);  // Dhat^+ d
    __syncthreads();
    own.stage<false, false>(uo, ue, t2, 1, t1, nullptr, 0.f, 0.f, g);  // H_oe t2
    __syncthreads();
    float dv[kOwnSites][4];
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (mine(j)) {
        Cx<float> h0, h1;
        hop_site_shared<false>(ue, uo, t1, s, own.nbrs(j, 0, g), g.V2, h0, h1);
        const float4 vs = t2[s], ds = d[s];
        h0 = axpby(m, lo(vs), -c, h0);
        h1 = axpby(m, hi(vs), -c, h1);
        t2[s] = f4(h0, h1);
        a[j][0] = h0.re, a[j][1] = h0.im, a[j][2] = h1.re, a[j][3] = h1.im;
        dv[j][0] = ds.x, dv[j][1] = ds.y, dv[j][2] = ds.z, dv[j][3] = ds.w;
      }
    }
    return dot(dv, a);
  }

  // x = x0 in registers and r = b - A x0, d = r; returns (||b||^2, <r, r>)
  // through bn and rho. b and x0: the chain's planar fields in global memory;
  // apply_A(a): A d into a and t2 with <d, A d> returned, as apply.
  template <typename Apply>
  __device__ __forceinline__ void start(const Apply& apply_A, const float* b, const float* x0,
                                        float& bn, float& rho) {
    float bv[kOwnSites][4], a[kOwnSites][4];
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (mine(j)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bv[j][q] = b[q * g.V2 + s];
          x[j][q] = x0[q * g.V2 + s];
        }
        d[s] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
    }
    bn = dot(bv, bv);
    apply_A(a);
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (mine(j)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[j][q] = bv[j][q] - a[j][q];
        const float4 rs = make_float4(bv[j][0], bv[j][1], bv[j][2], bv[j][3]);
        r[s] = rs;
        d[s] = rs;
      }
    }
    rho = dot(bv, bv);
  }

  // x += alpha d, r -= alpha Ad at the thread's sites; returns <r, r>
  __device__ __forceinline__ float update_x_r(float alpha) {
    float rv[kOwnSites][4];
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (mine(j)) {
        const float4 ds = d[s], as = t2[s], rs = r[s];
        const float dq[4] = {ds.x, ds.y, ds.z, ds.w}, aq[4] = {as.x, as.y, as.z, as.w};
        const float rq[4] = {rs.x, rs.y, rs.z, rs.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[j][q] = fma_rn(alpha, dq[q], x[j][q]);
          rv[j][q] = fma_rn(-alpha, aq[q], rq[q]);
        }
        r[s] = make_float4(rv[j][0], rv[j][1], rv[j][2], rv[j][3]);
      }
    }
    return dot(rv, rv);
  }

  // d = r + beta d: every thread is past both sums of the iteration, so no
  // thread still reads the old d at a neighbour
  __device__ __forceinline__ void update_d(float beta) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (mine(j)) {
        const float4 ds = d[s], rs = r[s];
        d[s] = make_float4(fma_rn(beta, ds.x, rs.x), fma_rn(beta, ds.y, rs.y),
                           fma_rn(beta, ds.z, rs.z), fma_rn(beta, ds.w, rs.w));
      }
    }
  }

  // x of the thread's sites into the chain's planar field in global memory
  __device__ __forceinline__ void write_x(float* out) const {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (mine(j)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * g.V2 + s] = x[j][q];
      }
    }
  }

  // The loop of cg_f32_op: the chain stays active while rho >= f32(tol^2)
  // ||b||^2 and fewer than max_iter iterations ran; with kGuards (K1, K2) a
  // non-positive dAd or a non-finite alpha freezes it before the update, a
  // non-finite rho_c after it. Without them (K6, as the Pallas loop) only
  // the stop rule ends it: a zero b runs one iteration to a NaN x and rho.
  // The operator is apply_A, with apply's contract (K10 passes its
  // tensor-core stages), or apply itself. Ends with a barrier.
  template <bool kGuards = true, typename Apply>
  __device__ __forceinline__ CgOut solve(const Apply& apply_A, const float* b, const float* x0,
                                         double tol, int max_iter) {
    float bnorm2, rho;
    start(apply_A, b, x0, bnorm2, rho);
    const float stop2 = static_cast<float>(tol * tol) * bnorm2;
    float a[kOwnSites][4];
    int iters = 0;
    for (int k = 0; k < max_iter && rho >= stop2; ++k) {
      const float dAd = apply_A(a);
      const float alpha = rho / dAd;
      if (kGuards && (!(dAd > 0.0f) || !isfinite(alpha))) break;
      const float rho_c = update_x_r(alpha);
      if (kGuards && !isfinite(rho_c)) break;
      update_d(rho_c / rho);
      rho = rho_c;
      ++iters;
    }
    __syncthreads();
    return {iters, rho, bnorm2};
  }
  template <bool kGuards = true>
  __device__ __forceinline__ CgOut solve(const float* b, const float* x0, double tol,
                                         int max_iter) {
    return solve<kGuards>([this](float (&a)[kOwnSites][4]) { return apply(a); }, b, x0, tol,
                          max_iter);
  }
};

// Dynamic shared memory of the CG store: links of both parities (32 bytes a
// site) and four spinors (64).
constexpr int kCgSharedBytes = 96;

// The CG store on the block's dynamic shared memory `smem` for geometry g.
__device__ __forceinline__ CgShared cg_shared(float* smem, double* sh, const Geo& g, float m,
                                              float c) {
  float4* planes = reinterpret_cast<float4*>(smem + 8 * g.V2);
  CgShared S{reinterpret_cast<float2*>(smem),
             reinterpret_cast<float2*>(smem + 4 * g.V2),
             planes,
             planes + g.V2,
             planes + 2 * g.V2,
             planes + 3 * g.V2,
             g,
             m,
             c,
             {sh, 0},
             {}};
  S.own.init(g);
  return S;
}

}  // namespace sm
