// Even-odd Wilson stencil on one chain's checkerboard planes, for the
// port's kernels (force_step.cu, solve_fused.cu, solve_mxu.cu,
// ratio_force.cu, solve_ru.cu, cg_fallback.cu with cg_fallback.cuh, cg_eo.cu,
// residual.cu, halo_normal.cu, halo_force.cu), with the fermion force
// stencil, the f32 CG loop (cg_f32_op) of the global paths of K1, K2, K6
// and K10, the stage of the global paths of the per-shard halo kernels K7
// and K8, the per-site hop (hop_bx, hop_combine) that every layout calls,
// K9's f64 slabs in shared memory and K10's tensor-core stages included,
// and two block sums: block_sum (three barriers; the global paths of K1,
// K2, K5, K6, K7, K9 and K10) and BlockSum (one barrier; K3, K4). The
// shared-memory layout, its one-barrier sum with block_sum's bits and the
// f32 CG on it (K1, K2, K6 and K10 up to 64x64) are in shared_stencil.cuh.
//
// Device counterpart of schwingermodel_tpu_torch/ops/eo.py (and of the
// packed stencil of schwingermodel_tpu/ops/pallas_eo.py:118-181), templated
// on the real type so that one source serves the f32 recursion and the f64
// true residual.
//
// Layout of one chain's parity field: component-major planes
// [comp][Nx][Nth] with V2 = Nx*Nth sites; a spinor has 4 components
// (spin0 re, spin0 im, spin1 re, spin1 im), links have 4 (u0 re, u0 im,
// u1 re, u1 im), angles 2 (theta0, theta1). Site s = x*Nth + k holds
// t = 2k + off(x), with off = (x + parity) & 1.
//
// Execution model: one thread block per chain (or per chain and shard), the
// block's threads stride over the V2 sites; a stencil stage reads neighbours
// that other threads wrote, so stages are separated by __syncthreads(). The
// fields lie where the kernel puts them: a per-chain global scratch that
// stays in L2 (K4; K1, K2, K3, K5, K6, K7, K8, K9 and K10 on a lattice or
// block no block holds), or shared memory (K1, K2, K5, K6, K7, K8, K10 and
// K3's f32 recursion in the site-major layout of shared_stencil.cuh, K9 in
// its f64 slabs of rows, residual.cu; all call hop_bx and hop_combine).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sm {

constexpr int kThreads = 512;

struct Geo {
  int Nx, Nth, V2;
};

template <typename T>
struct Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> cadd(Cx<T> a, Cx<T> b) { return {a.re + b.re, a.im + b.im}; }
template <typename T>
__device__ __forceinline__ Cx<T> csub(Cx<T> a, Cx<T> b) { return {a.re - b.re, a.im - b.im}; }
template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// conj(a) * b
template <typename T>
__device__ __forceinline__ Cx<T> cmulc(Cx<T> a, Cx<T> b) {
  return {a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re};
}
template <typename T>
__device__ __forceinline__ Cx<T> cconj(Cx<T> a) { return {a.re, -a.im}; }
// i * a
template <typename T>
__device__ __forceinline__ Cx<T> cmuli(Cx<T> a) { return {-a.im, a.re}; }
template <typename T>
__device__ __forceinline__ Cx<T> cneg(Cx<T> a) { return {-a.re, -a.im}; }

// complex component `comp` of a planar field at site s
template <typename T>
__device__ __forceinline__ Cx<T> ld(const T* __restrict__ p, int comp, int s, int V2) {
  return {p[(2 * comp) * V2 + s], p[(2 * comp + 1) * V2 + s]};
}
template <typename T>
__device__ __forceinline__ void st(T* __restrict__ p, int comp, int s, int V2, Cx<T> v) {
  p[(2 * comp) * V2 + s] = v.re;
  p[(2 * comp + 1) * V2 + s] = v.im;
}

__device__ __forceinline__ void sincos_t(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sincos_t(double a, double* s, double* c) { sincos(a, s, c); }

// Neighbour indices of target site s = (x, k) with packed offset `off`:
// pt/mt = the source-parity site at t+1 / t-1, px/mx = at x+1 / x-1.
struct Nbr {
  int pt, mt, px, mx;
};

__device__ __forceinline__ Nbr neighbours(int x, int k, int off, const Geo& g) {
  const int s = x * g.Nth + k;
  const int kp = (k + 1 == g.Nth) ? 0 : k + 1;
  const int km = (k == 0) ? g.Nth - 1 : k - 1;
  const int xp = (x + 1 == g.Nx) ? 0 : x + 1;
  const int xm = (x == 0) ? g.Nx - 1 : x - 1;
  Nbr n;
  n.pt = off ? x * g.Nth + kp : s;
  n.mt = off ? s : x * g.Nth + km;
  n.px = xp * g.Nth + k;
  n.mx = xm * g.Nth + k;
  return n;
}

// Folded links of one parity from its angles: u_mu = exp(i theta_mu), with
// the antiperiodic sign on u0 at global t = Nt-1 (packed column Nth-1 of
// the rows whose offset is 1). Angles are f32; T=double evaluates the
// exponential in f64 from the exact f32 values.
template <typename T>
__device__ void make_links_range(const float* __restrict__ th, int parity, T* __restrict__ u,
                                 const Geo& g, int lo, int hi) {
  for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) {
    const int x = s / g.Nth;
    const int k = s - x * g.Nth;
    const bool flip = ((x + parity) & 1) && (k == g.Nth - 1);
    for (int mu = 0; mu < 2; ++mu) {
      T sn, cs;
      sincos_t(static_cast<T>(th[mu * g.V2 + s]), &sn, &cs);
      if (mu == 0 && flip) {
        sn = -sn;
        cs = -cs;
      }
      u[(2 * mu) * g.V2 + s] = cs;
      u[(2 * mu + 1) * g.V2 + s] = sn;
    }
  }
}
template <typename T>
__device__ void make_links(const float* __restrict__ th, int parity, T* __restrict__ u,
                           const Geo& g) {
  make_links_range<T>(th, parity, u, g, 0, g.V2);
}

// Arithmetic with its roundings written out. Left to the compiler, a sum
// of two products becomes a fused multiply-add of one product onto the
// other, and which of the two is its choice per kernel. The hop below fixes
// the choice, so that every kernel that computes a hop, in place or in
// passes (solve_mxu.cu), gets the same bits.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ Cx<T> xadd(Cx<T> a, Cx<T> b) {
  return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
}
template <typename T>
__device__ __forceinline__ Cx<T> xsub(Cx<T> a, Cx<T> b) {
  return {add_rn(a.re, -b.re), add_rn(a.im, -b.im)};
}
template <typename T>
__device__ __forceinline__ Cx<T> xmul(Cx<T> a, Cx<T> b) {
  return {fma_rn(a.re, b.re, -mul_rn(a.im, b.im)), fma_rn(a.re, b.im, mul_rn(a.im, b.re))};
}
// conj(a) * b
template <typename T>
__device__ __forceinline__ Cx<T> xmulc(Cx<T> a, Cx<T> b) {
  return {fma_rn(a.re, b.re, mul_rn(a.im, b.im)), fma_rn(a.re, b.im, -mul_rn(a.im, b.re))};
}
// a v + b h, the mass term and the hop of one Dhat component
template <typename T>
__device__ __forceinline__ Cx<T> axpby(T a, Cx<T> v, T b, Cx<T> h) {
  return {fma_rn(a, v.re, mul_rn(b, h.re)), fma_rn(a, v.im, mul_rn(b, h.im))};
}

// The x-backward products of a hop, formed at the source site from its link
// u1s and spinor (s0, s1): conj(u1s) (s0 -+ i s1) and its partner.
template <typename T, bool DAG>
__device__ __forceinline__ void hop_bx(Cx<T> u1s, Cx<T> s0x, Cx<T> s1x, Cx<T>& bx0, Cx<T>& bx1) {
  if (!DAG) {
    bx0 = xmulc(u1s, xsub(s0x, cmuli(s1x)));
    bx1 = xmulc(u1s, xadd(cmuli(s0x), s1x));
  } else {
    bx0 = xmulc(u1s, xadd(s0x, cmuli(s1x)));
    bx1 = xmulc(u1s, xsub(s1x, cmuli(s0x)));
  }
}

// The hop at one target site from its gathered operands: the target links,
// the source spinor at t+1 (p*_pt) and x+1 (p*_px), the source link and
// spinor at t-1 (u0s, s0t, s1t) and the x-backward products from x-1.
template <typename T, bool DAG>
__device__ __forceinline__ void hop_combine(Cx<T> u0t, Cx<T> u1t, Cx<T> p0_pt, Cx<T> p1_pt,
                                            Cx<T> p0_px, Cx<T> p1_px, Cx<T> u0s, Cx<T> s0t,
                                            Cx<T> s1t, Cx<T> bx0, Cx<T> bx1, Cx<T>& h0,
                                            Cx<T>& h1) {
  if (!DAG) {
    const Cx<T> bt = xmulc(u0s, xadd(s0t, s1t));
    h0 = xadd(xadd(xmul(u0t, xsub(p0_pt, p1_pt)), xmul(u1t, xadd(p0_px, cmuli(p1_px)))),
              xadd(bt, bx0));
    h1 = xadd(xadd(xmul(u0t, xsub(p1_pt, p0_pt)), xmul(u1t, xsub(p1_px, cmuli(p0_px)))),
              xadd(bt, bx1));
  } else {
    const Cx<T> fwd_t = xmul(u0t, xadd(p0_pt, p1_pt));
    const Cx<T> bt = xmulc(u0s, xsub(s0t, s1t));
    h0 = xadd(xadd(bt, bx0), xadd(fwd_t, xmul(u1t, xsub(p0_px, cmuli(p1_px)))));
    h1 = xadd(xadd(cneg(bt), bx1), xadd(fwd_t, xmul(u1t, xadd(p1_px, cmuli(p0_px)))));
  }
}

// H (DAG=false) or H^+ (DAG=true) from the source parity to one target site
// (ops/eo.py hop / hop_dag). Ut: target-parity links, Us: source-parity
// links, S: source-parity spinor.
template <typename T, bool DAG>
__device__ __forceinline__ void hop_site(const T* __restrict__ Ut, const T* __restrict__ Us,
                                         const T* __restrict__ S, int s, const Nbr& n,
                                         int V2, Cx<T>& h0, Cx<T>& h1) {
  Cx<T> bx0, bx1;
  hop_bx<T, DAG>(ld(Us, 1, n.mx, V2), ld(S, 0, n.mx, V2), ld(S, 1, n.mx, V2), bx0, bx1);
  hop_combine<T, DAG>(ld(Ut, 0, s, V2), ld(Ut, 1, s, V2), ld(S, 0, n.pt, V2),
                      ld(S, 1, n.pt, V2), ld(S, 0, n.px, V2), ld(S, 1, n.px, V2),
                      ld(Us, 0, n.mt, V2), ld(S, 0, n.mt, V2), ld(S, 1, n.mt, V2), bx0, bx1,
                      h0, h1);
}

// out = hop(S) at the target sites [lo, hi) (v == nullptr), or
// out = a*v + b*hop(S).
template <typename T, bool DAG>
__device__ void hop_stage_range(const T* __restrict__ Ut, const T* __restrict__ Us,
                                const T* __restrict__ S, int tgt_parity, T* __restrict__ out,
                                const T* __restrict__ v, T a, T b, const Geo& g, int lo,
                                int hi) {
  for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) {
    const int x = s / g.Nth;
    const int k = s - x * g.Nth;
    const Nbr n = neighbours(x, k, (x + tgt_parity) & 1, g);
    Cx<T> h0, h1;
    hop_site<T, DAG>(Ut, Us, S, s, n, g.V2, h0, h1);
    if (v != nullptr) {
      h0 = axpby(a, ld(v, 0, s, g.V2), b, h0);
      h1 = axpby(a, ld(v, 1, s, g.V2), b, h1);
    }
    st(out, 0, s, g.V2, h0);
    st(out, 1, s, g.V2, h1);
  }
}
// The same at every target site.
template <typename T, bool DAG>
__device__ void hop_stage(const T* __restrict__ Ut, const T* __restrict__ Us,
                          const T* __restrict__ S, int tgt_parity, T* __restrict__ out,
                          const T* __restrict__ v, T a, T b, const Geo& g) {
  hop_stage_range<T, DAG>(Ut, Us, S, tgt_parity, out, v, a, b, g, 0, g.V2);
}

// The same stage on the width-extended block of one shard (K7, K8): the
// block is plain periodic in both axes (the wrap-around garbage enters one
// ring per hop and the crop removes it), and row x's even-parity offset
// comes from off_e[x], built from the global row index; the odd-parity
// offset is 1 - off_e[x].
template <typename T, bool DAG>
__device__ void hop_stage_ext(const T* __restrict__ Ut, const T* __restrict__ Us,
                              const T* __restrict__ S, const int* __restrict__ off_e,
                              int tgt_parity, T* __restrict__ out, const T* __restrict__ v, T a,
                              T b, const Geo& g) {
  for (int s = threadIdx.x; s < g.V2; s += blockDim.x) {
    const int x = s / g.Nth;
    const int k = s - x * g.Nth;
    const Nbr n = neighbours(x, k, off_e[x] ^ tgt_parity, g);
    Cx<T> h0, h1;
    hop_site<T, DAG>(Ut, Us, S, s, n, g.V2, h0, h1);
    if (v != nullptr) {
      h0 = axpby(a, ld(v, 0, s, g.V2), b, h0);
      h1 = axpby(a, ld(v, 1, s, g.V2), b, h1);
    }
    st(out, 0, s, g.V2, h0);
    st(out, 1, s, g.V2, h1);
  }
}

// Halo width of the extended block: Dhat Dhat^+ is four hops, each consumes
// one ring (ops/eo_halo.py W).
constexpr int kHaloW = 4;
// Dynamic shared memory a kernel may ask for: the card's 227 KB per block
// less the static part and a margin (K3, K7, K8).
constexpr int kSharedMax = 220 * 1024;

// Copy n floats from global to shared memory, 16 bytes a thread where the
// count and both addresses allow.
__device__ __forceinline__ void copy_in(float* __restrict__ dst, const float* __restrict__ src,
                                        int n) {
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0 &&
      (reinterpret_cast<size_t>(dst) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// out = (Dhat Dhat^+) v on the even sublattice; t1..t3 are scratch spinors.
// Starts with a barrier, so v may have been written elementwise just before.
template <typename T>
__device__ void normal_apply(const T* ue, const T* uo, const T* v, T* out, T* t1, T* t2, T* t3,
                             T m, T c, const Geo& g) {
  __syncthreads();
  hop_stage<T, true>(uo, ue, v, 1, t1, nullptr, T(0), T(0), g);  // (H_eo)^+ v
  __syncthreads();
  hop_stage<T, true>(ue, uo, t1, 0, t2, v, m, -c, g);  // Dhat^+ v
  __syncthreads();
  hop_stage<T, false>(uo, ue, t2, 1, t3, nullptr, T(0), T(0), g);  // H_oe t2
  __syncthreads();
  hop_stage<T, false>(ue, uo, t3, 0, out, t2, m, -c, g);  // Dhat t2
  __syncthreads();
}

// Sum of one double per thread over the block, returned to every thread.
// sh holds at least 33 doubles.
__device__ __forceinline__ double block_sum(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = (lane < nw) ? sh[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const double r = sh[32];
  __syncthreads();
  return r;
}

// The same sum with one barrier (K3, K4): every warp writes its partial,
// one __syncthreads(), and every thread adds the kThreads / 32 partials in
// the same order, so all threads hold the same bits. Successive sums
// alternate between two sets of slots: a set is written again only by a
// thread that has passed the barrier of the sum in between, which no thread
// passes before every thread has read the set. The block has kThreads
// threads; sh holds 2 * (kThreads / 32) doubles of shared memory.
struct BlockSum {
  double* sh;
  int set;
  __device__ __forceinline__ double operator()(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    double* slot = sh + set * (kThreads / 32);
    set ^= 1;
    if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
    __syncthreads();
    double tot = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) tot += slot[w];
    return tot;
  }
  // Re<a, b> over n planar values, accumulated in f64
  template <typename T, typename U>
  __device__ __forceinline__ double dot(const T* a, const U* b, int n) {
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads)
      acc += static_cast<double>(a[i]) * static_cast<double>(b[i]);
    return (*this)(acc);
  }
};

// Re<a, b> over n planar values, accumulated in f64.
template <typename T>
__device__ double block_dot(const T* __restrict__ a, const T* __restrict__ b, int n, double* sh) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    acc += static_cast<double>(a[i]) * static_cast<double>(b[i]);
  return block_sum(acc, sh);
}

// Reference force stencil f_mu at one parity-p site from its gathered
// operands: the site's links u0, u1, left operand x and right operand y
// on-site (x0, x1, y0, y1, parity p), and the opposite parity's x and y at
// n+t (*t) and n+x (*x) (pallas_traj._fermion_force_p).
__device__ __forceinline__ void fermion_force_ops(Cx<float> u0, Cx<float> u1, Cx<float> x0,
                                                  Cx<float> x1, Cx<float> y0, Cx<float> y1,
                                                  Cx<float> x0t, Cx<float> x1t,
                                                  Cx<float> y0t, Cx<float> y1t,
                                                  Cx<float> x0x, Cx<float> x1x,
                                                  Cx<float> y0x, Cx<float> y1x, float& f0,
                                                  float& f1) {
  const Cx<float> yt = csub(y0t, y1t);
  const Cx<float> xt = cadd(x0t, x1t);
  const Cx<float> yx = cadd(y0x, cmuli(y1x));
  const Cx<float> xx = csub(x0x, cmuli(x1x));
  f0 = cmul(u0, cmul(cconj(csub(x0, x1)), yt)).im -
       cmul(cconj(u0), cmul(cconj(xt), cadd(y0, y1))).im;
  f1 = cmul(u1, cmul(cconj(cadd(x0, cmuli(x1))), yx)).im +
       cmul(cconj(u1), cmul(cconj(xx), cadd(cneg(y0), cmuli(y1)))).im;
}

// The same on planar fields at site s: *_p on-site, *_q the opposite parity.
// Used by the global paths of K1 and K5.
__device__ __forceinline__ void fermion_force_site(const float* u, const float* xp,
                                                   const float* yp, const float* xq,
                                                   const float* yq, int s, const Nbr& n,
                                                   int V2, float& f0, float& f1) {
  fermion_force_ops(ld(u, 0, s, V2), ld(u, 1, s, V2), ld(xp, 0, s, V2), ld(xp, 1, s, V2),
                    ld(yp, 0, s, V2), ld(yp, 1, s, V2), ld(xq, 0, n.pt, V2),
                    ld(xq, 1, n.pt, V2), ld(yq, 0, n.pt, V2), ld(yq, 1, n.pt, V2),
                    ld(xq, 0, n.px, V2), ld(xq, 1, n.px, V2), ld(yq, 0, n.px, V2),
                    ld(yq, 1, n.px, V2), f0, f1);
}

// Im P(n) of the plaquette u0(n) u1(n+t) conj(u0(n+x) u1(n)) from its links.
__device__ __forceinline__ float plaq_im(Cx<float> u0, Cx<float> u1t, Cx<float> u0x,
                                         Cx<float> u1) {
  return cmul(cmul(u0, u1t), cconj(cmul(u0x, u1))).im;
}

// Result of cg_f32_op, the same in every thread of the block.
struct CgOut {
  int iters;    // iterations while the chain was active
  float rho;    // last recursive residual norm^2 (f32)
  float bnorm2; // ||b||^2 (f32)
};

// f32 CG on A x = b for one chain with A = Dhat Dhat^+ given as
// apply_A(v, out), which starts and ends with a barrier: the loop of
// pallas_traj._cg_planes run per chain (K2, K10, and K1 with_solve): x starts at
// x0 and r = b - A x0; the chain stays active while rho >= f32(tol^2)
// ||b||^2 and fewer than max_iter iterations ran. Breakdown guards, checked
// before the x/r update: dAd <= 0 or a non-finite alpha; then, after it, a
// non-finite rho_c. Either freezes the chain (the loop exits, rho keeps its
// last finite value, so converged = rho < stop2 is false). kGuards=false
// drops both, as the loop of pallas_eo._cg_kernel has none (K6; its
// shared path drops them from CgShared::solve the same way): a
// breakdown then runs its iteration to the end, a NaN rho fails the stop
// test and the loop exits with converged = false and x as the arithmetic
// left it. A NaN in b makes rho NaN and the loop never starts: x = x0.
// Dots are accumulated in f64 and rounded to f32, as the Pallas kernel's
// f32 dots are. The lockstep jnp.any test of the Pallas loop becomes this
// per-chain loop: a frozen chain does not change there either. Ends with a
// barrier, so x may be read at any site afterwards. r, d, Ad: scratch
// spinors.
template <bool kGuards = true, typename Apply>
__device__ inline CgOut cg_f32_op(const Apply& apply_A, const float* b, const float* x0, float* x,
                                  float* r, float* d, float* Ad, double tol, int max_iter,
                                  const Geo& g, double* sh) {
  const int n = 4 * g.V2;
  const float bnorm2 = static_cast<float>(block_dot(b, b, n, sh));
  const float stop2 = static_cast<float>(tol * tol) * bnorm2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = x0[i];
  apply_A(x, Ad);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    r[i] = b[i] - Ad[i];
    d[i] = r[i];
  }
  float rho = static_cast<float>(block_dot(r, r, n, sh));
  int iters = 0;
  for (int k = 0; k < max_iter && rho >= stop2; ++k) {
    apply_A(d, Ad);
    const float dAd = static_cast<float>(block_dot(d, Ad, n, sh));
    const float alpha = rho / dAd;
    if (kGuards && (!(dAd > 0.0f) || !isfinite(alpha))) break;
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      x[i] += alpha * d[i];
      const float ri = r[i] + (-alpha) * Ad[i];
      r[i] = ri;
      acc += static_cast<double>(ri) * static_cast<double>(ri);
    }
    const float rho_c = static_cast<float>(block_sum(acc, sh));
    if (kGuards && !isfinite(rho_c)) break;
    const float beta = rho_c / rho;
    for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = r[i] + beta * d[i];
    rho = rho_c;
    ++iters;
  }
  __syncthreads();
  return {iters, rho, bnorm2};
}

// out = (Dhat Dhat^+) v through normal_apply, as cg_f32_op takes its
// operator: starts and ends with a barrier.
struct NormalOp {
  const float *ue, *uo;
  float *t1, *t2, *t3;
  float m, c;
  Geo g;
  __device__ __forceinline__ void operator()(const float* v, float* out) const {
    normal_apply<float>(ue, uo, v, out, t1, t2, t3, m, c, g);
  }
};

// cg_f32_op on the stencil of this header (the global paths of K1, K2, K6).
template <bool kGuards = true>
__device__ inline CgOut cg_f32(const float* ue, const float* uo, const float* b, const float* x0,
                               float* x, float* r, float* d, float* Ad, float* t1, float* t2,
                               float* t3, float m, float c, double tol, int max_iter,
                               const Geo& g, double* sh) {
  return cg_f32_op<kGuards>(NormalOp{ue, uo, t1, t2, t3, m, c, g}, b, x0, x, r, d, Ad, tol,
                            max_iter, g, sh);
}

}  // namespace sm
