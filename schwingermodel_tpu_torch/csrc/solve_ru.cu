// K3: reliable-update mixed-precision CG on (Dhat Dhat^+) x = b, with the
// f64 fallback (K4's body) at the end of the same launch.
//
// Replaces schwingermodel_tpu/ops/pallas_df.py:_solve_ru_kernel
// (solve_refined_fused, with its history of K >= 1 solutions) and, where
// the caller asks for the fallback, the lax.cond around _df_cg_fb_kernel. The algorithm is kept and
// the double-float half becomes native f64: one continuous f32 CG recursion;
// x accumulated in f64 as x += (double)alpha * (double)d; each time the
// recursive residual has contracted by tau it is replaced by the true
// residual b - A x evaluated in f64 (links from sincos((double)theta)) and
// rounded to f32. certify=false trusts the recursive exit for segments
// shorter than cert_k iterations. Semantics are per chain: every decision
// (inner target, replacement gate, stagnation test, iteration cap, whether
// the fallback runs) reads only that chain's state -- the reference's
// one-CG-per-chain semantics.
//
// The start: hist[0] where the history has one entry; with 2 <= K <= kMreMax
// the MRE forecast over it (chronological inversion, pallas_df.py:454-492),
// as a prologue of the same launch on every path (mre_forecast): the
// correction sum_i c_i v_i, v_i = hist[i] - hist[0], that minimises
// |r1 - sum_i c_i w_i|, r1 = b - A hist[0] and w_i = A hist[i] - A hist[0],
// from one pass of Gram sums. A in f32 through the path's own stencil (a
// shared-memory apply of the recursion's links on the shared and cluster
// paths), applied to each hist[i] in turn; the thread keeps A hist[0], r1
// and the w_i it needs again at its own sites (the w_i in registers on the
// shared and cluster paths, A hist[0] and r1 in the r and t2 planes on the
// shared path, in the planes not yet filled on the global path) and
// accumulates <w_i, w_j> (j <= i) and <r1, w_i> in f64, its warps' partials
// into shared slots; one chain sum of the K (K + 1) / 2 - 1 values (9 at
// K = 4); every thread then solves the (K - 1) x (K - 1) system by an f64
// Cholesky, the same bits everywhere, and drops a direction whose pivot, its
// squared Schmidt norm (the |w|^2 of modified Gram-Schmidt), is not above
// 1e-8 of the largest, as MGS does (a duplicate history leaves x0 = hist[0]
// exactly); x0 = hist[0] + sum_i c_i v_i in f64 from one more read of the
// history, straight into the recursion's x. No per-chain scratch: the
// prologue reads the history twice and costs K applies and one chain sum.
// The kernels are instantiated on whether a history is present (MRE), so the
// K = 1 kernels hold no prologue. Its cycles are the clocks' fourth column,
// read only where K > 1.
//
// What bounds it on the card: per iteration one normal apply (4 dependent
// stencil stages of ~150 flops per site) and 2 block reductions on 2048
// sites per chain at 64x64, i.e. the latency of barriers and of what a
// thread waits for after each, not bandwidth or flops. One thread block of
// 512 threads per chain (or 2-8 blocks of rows) runs the whole solve, so no
// host synchronisation or relaunch happens per iteration. Where the vectors
// of the f32 recursion live is chosen by lattice size, chain count and what
// the card runs at once before the launch (ops/refined.ru_path):
//
// - shared (up to 64x64: V2 = Nx Nt/2 <= 2048 sites): the f32 links of both
//   parities, d, r and two stencil temporaries are six fields of 4 floats a
//   site in the dynamic shared memory of one block, site-major, so that a
//   neighbour's spinor is one 16-byte load: 96 V2 bytes, 192 KiB at 64x64
//   (the third temporary takes the first one's place and Ad the second
//   one's). A thread owns the sites tid + j * 512, j < 4: its x (f64) stays
//   in registers, the fourth stencil stage forms the <d, Ad> partial where it
//   holds Ad, and a block sum costs one barrier. 6 barriers an iteration,
//   none followed by a trip to L2; the inner loop reads no vector from global
//   memory and is bound by what one SM issues and by its shared-memory
//   bandwidth (~10 thousand cycles an iteration at 128 bytes a cycle). The
//   f64 true residual (2-3 a solve) runs through a global scratch of 20 V2
//   doubles, x written out from the registers before it;
// - all shared (up to 32x32 and a little above): the f64 links and the true
//   residual's three fields (160 V2 bytes) lie in shared memory too;
// - cluster (a lattice too large for one block, 128x128): the same
//   recursion (RuCluster) on a thread-block cluster of 2, 4 or 8 blocks a
//   chain, each with its rows of x between two halo rows, the neighbour
//   blocks' edge rows, stored through distributed shared memory and counted
//   on the receiving block's mbarrier, so that no stage waits at a cluster
//   barrier (a cluster.sync() costs ~1500 cycles, ~0.75 us, on the H100,
//   where __syncthreads() costs ~240). Where one block holds the lattice a
//   cluster is the slower choice and is not taken;
// - L2 (a lattice too large for one block, whose C clusters the card does
//   not run at once but whose C n blocks it does: 128x128 at C = 32, where
//   the H100 runs 30 clusters of 4 and 132 blocks): the same recursion on n
//   ordinary blocks a chain anywhere on the card, one cooperative launch,
//   the halo rows and the sums exchanged through global memory, which stays
//   in L2 (RuCluster<true>): the thread of an edge site stores it into its
//   block's slot as words that carry the phase beside the value; the thread
//   beside the halo site loads them until they hold its phase and puts the
//   site into the block's halo row. Where the card would run the clusters
//   in two waves, one wave over L2 is the faster (ops/refined.ru_path);
// - global (what no cluster holds): every vector in a per-chain global
//   scratch of 28 V2 floats and 20 V2 doubles that stays in L2, 7 barriers
//   an iteration, 5 of them followed by neighbour reads from L2.
//
// Dots are accumulated in f64 and rounded to f32. A chain that ends
// unconverged runs cg_fallback_chain (cg_fallback.cuh) from its f64 x in the
// same block when the caller asked for the fallback; a converged chain pays
// nothing for it.
#include <cooperative_groups.h>

#include <cfloat>

#include "cg_fallback.cuh"
#include "shared_stencil.cuh"

namespace sm {

namespace cg = cooperative_groups;

struct RuParams {
  const float *thE, *thO, *b;
  const float* hist;  // [K, C, 4 V2]: the start (K = 1) or the MRE history, newest first
  int K, C;
  float* x;
  double* x64;
  int *iters, *fb_iters;
  unsigned char* conv;
  float* s32;
  double* s64;
  // [C, 4]: cycles of the solve, of its true residuals, of rank 0's thread
  // 0 waiting on the other blocks of its chain (0 on the one-block paths)
  // and of that thread in the MRE prologue (0 at K = 1); may be null
  long long* clocks;
  int Nx, Nth;
  double m0, tol, tau;
  int max_iter, max_outer, certify, cert_k;
  int fallback, fb_max_iter, fb_max_rounds;
  int f64_shared;  // shared path only: the f64 set lies in shared memory too
  // L2 path only: the exchange areas (ru_l2_words a chain, 0 between
  // launches) and the blocks a chain
  unsigned long long* xch;
  int blocks;
};

// f64 scratch values per half-lattice site and chain: the links and the true
// residual's three planes unless they lie in shared memory, and the
// fallback's planes, which take the place of the true residual's
__host__ __device__ inline int ru_s64_values(bool f64_shared, bool fallback) {
  const int links = f64_shared ? 0 : 8, res = f64_shared ? 0 : 12;
  const int fb = fallback ? kFbScratch : 0;
  return links + (fb > res ? fb : res);
}

// The reliable-update loop of one chain on a store of its vectors: the
// control flow of the solve, the same on every path. Returns the flag.
template <class Store>
__device__ __forceinline__ bool ru_loop(Store& S, const RuParams& p, int& iters) {
  const float bnorm2 = S.bnorm2();
  const float stop2 = static_cast<float>(p.tol * p.tol) * bnorm2;
  const float tau2 = static_cast<float>(p.tau * p.tau);

  float rho = S.true_residual();
  // forecast sanitizer: a start worse than x = 0 restarts from x = 0,
  // whose residual is b exactly
  if (rho > bnorm2) {
    S.restart_from_zero();
    rho = bnorm2;
  }
  S.d_from_r();

  float rho_df = rho, rho_df_prev = INFINITY;
  int k_tot = 0, k_rep = 0, ko = 0;
  iters = 0;
  while (rho_df >= stop2 && ko < p.max_outer && (ko == 0 || rho_df * 4.0f <= rho_df_prev) &&
         k_tot < p.max_iter) {
    // chase tau^2 below the certified residual, or the final target
    const float tgt = fmaxf(stop2, tau2 * rho_df);
    bool dead = false;
    while (!dead && rho >= tgt && k_tot < p.max_iter) {
      const float dAd = S.apply_dAd();
      const float alpha = rho / dAd;
      ++k_tot;
      // breakdown: non-positive curvature or alpha overflow freezes the
      // chain before its state is touched
      if (!(dAd > 0.0f) || !isfinite(alpha)) {
        dead = true;
        break;
      }
      const float rho_c = S.update_x_r(alpha);
      // overflow or runaway divergence: freeze with x and r as updated
      if (!isfinite(rho_c) || rho_c > 1e6f * bnorm2) {
        dead = true;
        break;
      }
      S.update_d(rho_c / rho);
      rho = rho_c;
      ++iters;
    }
    // reliable update: always when certifying, otherwise only for a
    // multi-phase contraction or a segment of cert_k iterations or more
    if (p.certify || tgt > stop2 || k_tot - k_rep >= p.cert_k) {
      rho = S.true_residual();
      k_rep = k_tot;
    }
    rho_df_prev = rho_df;
    rho_df = rho;
    ++ko;
  }
  return rho_df < stop2;
}

// What both stores share: the f64 half and the chain's constants.
struct RuF64 {
  const float* b;
  double* x64;  // the chain's f64 x in global memory (an output)
  double *ue64, *uo64, *Ax, *u1, *u2;  // f64 links, A x, two stencil temporaries
  Geo g;
  float m, c;
  double m64, c64;
  // cycles in the true residuals. The clocks are read whether or not the
  // caller takes them (one pair a true residual, 2-3 a solve): on the H100
  // the kernel without them, by a flag of the launch or as an instantiation
  // of its own, was 2-4% slower in turns.
  long long t_res;
  // cycles spent waiting on the other blocks of the chain (RuCluster's
  // barriers, halo rows and sums, on either transport); 0 on the one-block
  // paths
  long long t_wait;
};

// The MRE prologue's sizes: the most solutions it takes (the thread keeps
// w_1 .. w_{K-2} at its own sites, 32 floats in registers at K = 4), its
// chain sums for a history of K (<w_i, w_j> for j <= i and <r1, w_i>,
// i = 1 .. K-1), and the warps whose partials each sum adds.
constexpr int kMreMax = 4;
__host__ __device__ constexpr int mre_sums(int K) { return (K - 1) * (K + 2) / 2; }
constexpr int kMreSums = mre_sums(kMreMax);
constexpr int kWarps = kThreads / 32;

// A spinor the prologue keeps at the thread's own sites: in registers by own
// site j (the shared and cluster paths, kOwnSites a thread) ...
struct OwnRegs {
  float4 v[kOwnSites];
  __device__ __forceinline__ float4 get(int j, int) const { return v[j]; }
  __device__ __forceinline__ void set(int j, int, float4 a) { v[j] = a; }
};
// ... in a site-major plane of shared memory, site s at p[s + off] ...
struct OwnSmem {
  float4* p;
  int off;
  __device__ __forceinline__ float4 get(int, int s) const { return p[s + off]; }
  __device__ __forceinline__ void set(int, int s, float4 a) { p[s + off] = a; }
};
// ... or in a planar [4][V2] plane by site s (the global path)
struct OwnPlane {
  float* p;
  int V2;
  __device__ __forceinline__ float4 get(int, int s) const {
    return make_float4(p[s], p[V2 + s], p[2 * V2 + s], p[3 * V2 + s]);
  }
  __device__ __forceinline__ void set(int, int s, float4 a) {
    p[s] = a.x;
    p[V2 + s] = a.y;
    p[2 * V2 + s] = a.z;
    p[3 * V2 + s] = a.w;
  }
};

// v added over the warp by BlockSumTree's shuffle tree, lane 0 storing it in
// the warp's slot
__device__ __forceinline__ void warp_slot(double v, double* slot) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
}

// The first M of the prologue's sums over the block, from their warps'
// slots (kWarps each) after one barrier, by warp_partials_sum: the same bits
// in every thread; the rest 0
__device__ __forceinline__ void block_sums(const double* slots, int M,
                                           double (&out)[kMreSums]) {
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kMreSums; ++v) out[v] = v < M ? warp_partials_sum(slots + v * kWarps) : 0.0;
}

// Every vector in the global scratch; a thread owns the planar indices
// tid + k * 512.
struct RuGlobal : RuF64 {
  float *ue, *uo, *r, *d, *Ad, *t1, *t2;
  int n;
  BlockSum& sum;

  __device__ __forceinline__ float bnorm2() { return static_cast<float>(sum.dot(b, b, n)); }
  // r = f32(b - A x) in f64; returns <r, r>
  __device__ __forceinline__ float true_residual() {
    const long long t0 = clock64();
    normal_apply<double>(ue64, uo64, x64, Ax, u1, u2, u1, m64, c64, g);
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float ri = static_cast<float>(static_cast<double>(b[i]) - Ax[i]);
      r[i] = ri;
      acc += static_cast<double>(ri) * static_cast<double>(ri);
    }
    const float rho = static_cast<float>(sum(acc));
    t_res += clock64() - t0;
    return rho;
  }
  __device__ __forceinline__ void restart_from_zero() {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      x64[i] = 0.0;
      r[i] = b[i];
    }
  }
  __device__ __forceinline__ void d_from_r() {
    for (int i = threadIdx.x; i < n; i += kThreads) d[i] = r[i];
  }
  __device__ __forceinline__ float apply_dAd() {
    normal_apply<float>(ue, uo, d, Ad, t1, t2, t1, m, c, g);
    return static_cast<float>(sum.dot(d, Ad, n));
  }
  __device__ __forceinline__ float update_x_r(float alpha) {
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      x64[i] = fma_rn(static_cast<double>(alpha), static_cast<double>(d[i]), x64[i]);
      const float ri = fma_rn(-alpha, Ad[i], r[i]);
      r[i] = ri;
      acc += static_cast<double>(ri) * static_cast<double>(ri);
    }
    return static_cast<float>(sum(acc));
  }
  __device__ __forceinline__ void update_d(float beta) {
    for (int i = threadIdx.x; i < n; i += kThreads) d[i] = fma_rn(beta, d[i], r[i]);
  }

  // the MRE prologue's pieces (mre_forecast): f(j, s) at the thread's own
  // sites (the j-th, planar index s); what it keeps, A hist[0], r1 and the
  // w_i, in the planes the recursion has not filled yet (r, d, and the two
  // float planes of A x of the f64 true residual); f(j, s, A src) at its own
  // sites, A src in Ad; the chain's sums; x0
  using A0 = OwnPlane;
  using R1 = OwnPlane;
  using W = OwnPlane;
  template <class F>
  __device__ __forceinline__ void each_own(F f) const {
    for (int s = threadIdx.x, j = 0; s < g.V2; s += kThreads, ++j) f(j, s);
  }
  __device__ __forceinline__ OwnPlane stash_a0() const { return {r, g.V2}; }
  __device__ __forceinline__ OwnPlane stash_r1() const {
    return {reinterpret_cast<float*>(Ax), g.V2};
  }
  __device__ __forceinline__ OwnPlane stash_w(int i) const {
    return {i == 0 ? d : reinterpret_cast<float*>(Ax) + 4 * g.V2, g.V2};
  }
  template <class F>
  __device__ __forceinline__ void apply_A_own(const float* src, F f) {
    normal_apply<float>(ue, uo, src, Ad, t1, t2, t1, m, c, g);
    each_own([&](int j, int s) {
      f(j, s, make_float4(Ad[s], Ad[g.V2 + s], Ad[2 * g.V2 + s], Ad[3 * g.V2 + s]));
    });
  }
  __device__ __forceinline__ void chain_sums(const double* slots, double*, int M,
                                             double (&out)[kMreSums]) {
    block_sums(slots, M, out);
  }
  __device__ __forceinline__ void set_x(int, int s, const double (&v)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x64[q * g.V2 + s] = v[q];
  }
};

// The f32 recursion in one block's shared memory, site-major (a spinor is
// one float4 a site, a link one float2); x (f64) of the thread's own sites
// in registers. RuCluster below is the same recursion on a cluster of
// blocks; run on one block it was 15-20% slower than this store in every
// form tried (halo rows for the wrap, or the wrap by index under a
// compile-time switch: 0.42-0.44 ms against 0.36 on the timed input, with
// twice the register spills), so the two stay apart and share the loop
// (ru_loop), the hop (hop_site_shared) and the f64 half (RuF64).
struct RuShared : RuF64 {
  float2 *ue, *uo;          // links of 2 V2 float2 each
  float4 *d, *r, *t1, *t2;  // spinors of V2 float4 each
  BlockSum& sum;
  OwnSites own;
  double x[kOwnSites][4];

  __device__ __forceinline__ void init_sites() { own.init(g); }

  __device__ __forceinline__ void init(const float* x0) {
    own.init(g);
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[j][q] = static_cast<double>(x0[q * g.V2 + s]);
      }
    }
  }

  // the MRE prologue's pieces (mre_forecast), as RuGlobal's: the w_i in
  // registers, A hist[0] in r's place and r1 in t2's (apply_A_own leaves it)
  using A0 = OwnSmem;
  using R1 = OwnSmem;
  using W = OwnRegs;
  template <class F>
  __device__ __forceinline__ void each_own(F f) const {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) f(j, s);
    }
  }
  __device__ __forceinline__ OwnSmem stash_a0() const { return {r, 0}; }
  __device__ __forceinline__ OwnSmem stash_r1() const { return {t2, 0}; }
  __device__ __forceinline__ OwnRegs stash_w(int) const { return {}; }
  __device__ __forceinline__ void chain_sums(const double* slots, double*, int M,
                                             double (&out)[kMreSums]) {
    block_sums(slots, M, out);
  }
  __device__ __forceinline__ void set_x(int j, int, const double (&v)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[j][q] = v[q];
  }

  // f(j, s, A src) at the thread's own sites, src planar [4][V2] in global
  // memory: the stages of apply_dAd on d and t1 alone, before the recursion
  // uses them, src in d's place and Dhat^+ src over it (the second stage
  // reads src only at the site it writes, the first stage's reads of its
  // neighbours are past the barrier between). The barrier after the load
  // orders it after the previous apply's reads of t1 and of d at the
  // neighbours (every thread has passed its third stage).
  template <class F>
  __device__ __forceinline__ void apply_A_own(const float* src, F f) {
    each_own([&](int, int s) {
      d[s] = make_float4(src[s], src[g.V2 + s], src[2 * g.V2 + s], src[3 * g.V2 + s]);
    });
    __syncthreads();
    stage<true, false>(uo, ue, d, 1, t1, nullptr, 0.f, 0.f);
    __syncthreads();
    stage<true, true>(ue, uo, t1, 0, d, d, m, -c);
    __syncthreads();
    stage<false, false>(uo, ue, d, 1, t1, nullptr, 0.f, 0.f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
        Cx<float> h0, h1;
        hop_site_shared<false>(ue, uo, t1, s, own.nbrs(j, 0, g), g.V2, h0, h1);
        const float4 vs = d[s];
        h0 = axpby(m, lo(vs), -c, h0);
        h1 = axpby(m, hi(vs), -c, h1);
        f(j, s, f4(h0, h1));
      }
    }
  }

  template <bool DAG, bool AXPBY>
  __device__ __forceinline__ void stage(const float2* Ut, const float2* Us, const float4* S,
                                        int tgt_parity, float4* out, const float4* v, float a,
                                        float bb) const {
    own.stage<DAG, AXPBY>(Ut, Us, S, tgt_parity, out, v, a, bb, g);
  }

  __device__ __forceinline__ float bnorm2() {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const double bi = b[q * g.V2 + s];
          acc += bi * bi;
        }
      }
    }
    return static_cast<float>(sum(acc));
  }

  // r = f32(b - A x) in f64, x written out from the registers first;
  // returns <r, r>
  __device__ __forceinline__ float true_residual() {
    const long long t0 = clock64();
    write_x64();
    normal_apply<double>(ue64, uo64, x64, Ax, u1, u2, u1, m64, c64, g);
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
        float ri[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = q * g.V2 + s;
          ri[q] = static_cast<float>(static_cast<double>(b[i]) - Ax[i]);
          acc += static_cast<double>(ri[q]) * static_cast<double>(ri[q]);
        }
        r[s] = make_float4(ri[0], ri[1], ri[2], ri[3]);
      }
    }
    const float rho = static_cast<float>(sum(acc));
    t_res += clock64() - t0;
    return rho;
  }

  __device__ __forceinline__ void restart_from_zero() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[j][q] = 0.0;
        r[s] = make_float4(b[s], b[g.V2 + s], b[2 * g.V2 + s], b[3 * g.V2 + s]);
      }
    }
  }

  __device__ __forceinline__ void d_from_r() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) d[s] = r[s];
    }
  }

  // Ad = (Dhat Dhat^+) d at the thread's sites, left in t2's place (the
  // fourth stage reads t2 only at the thread's own site); returns <d, Ad>.
  // The first barrier makes the d that update_d or d_from_r wrote visible;
  // t1 holds (H_eo)^+ d and then H_oe t2.
  __device__ __forceinline__ float apply_dAd() {
    __syncthreads();
    stage<true, false>(uo, ue, d, 1, t1, nullptr, 0.f, 0.f);
    __syncthreads();
    stage<true, true>(ue, uo, t1, 0, t2, d, m, -c);
    __syncthreads();
    stage<false, false>(uo, ue, t2, 1, t1, nullptr, 0.f, 0.f);
    __syncthreads();
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
        Cx<float> h0, h1;
        hop_site_shared<false>(ue, uo, t1, s, own.nbrs(j, 0, g), g.V2, h0, h1);
        const float4 vs = t2[s], ds = d[s];
        h0 = axpby(m, lo(vs), -c, h0);
        h1 = axpby(m, hi(vs), -c, h1);
        t2[s] = make_float4(h0.re, h0.im, h1.re, h1.im);
        acc += static_cast<double>(ds.x) * static_cast<double>(h0.re);
        acc += static_cast<double>(ds.y) * static_cast<double>(h0.im);
        acc += static_cast<double>(ds.z) * static_cast<double>(h1.re);
        acc += static_cast<double>(ds.w) * static_cast<double>(h1.im);
      }
    }
    return static_cast<float>(sum(acc));
  }

  __device__ __forceinline__ float update_x_r(float alpha) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
        const float4 ds = d[s], as = t2[s], rs = r[s];
        const float dq[4] = {ds.x, ds.y, ds.z, ds.w}, aq[4] = {as.x, as.y, as.z, as.w};
        float rq[4] = {rs.x, rs.y, rs.z, rs.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[j][q] = fma_rn(static_cast<double>(alpha), static_cast<double>(dq[q]), x[j][q]);
          rq[q] = fma_rn(-alpha, aq[q], rq[q]);
          acc += static_cast<double>(rq[q]) * static_cast<double>(rq[q]);
        }
        r[s] = make_float4(rq[0], rq[1], rq[2], rq[3]);
      }
    }
    return static_cast<float>(sum(acc));
  }

  // every thread is past both block sums of the iteration, so no thread
  // still reads the old d at a neighbour
  __device__ __forceinline__ void update_d(float beta) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
        const float4 ds = d[s], rs = r[s];
        d[s] = make_float4(fma_rn(beta, ds.x, rs.x), fma_rn(beta, ds.y, rs.y),
                           fma_rn(beta, ds.z, rs.z), fma_rn(beta, ds.w, rs.w));
      }
    }
  }

  __device__ __forceinline__ void write_x64() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < g.V2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x64[q * g.V2 + s] = x[j][q];
      }
    }
  }
};

// Blocks of one chain's cluster at most.
constexpr int kRuClusterMax = 8;

// The L2 path's exchange area of a chain of N blocks of rows of Nth sites,
// in 8-byte words: each block's two edge rows for each of the 4 halo
// mailboxes and 2 phases, a site in 4 words; each block's kMreSums sums of
// 2 phases, a sum in 2 words; the arrivals at the chain's barriers; whole
// 128-byte lines. A word holds 32 bits of a value and, above them, the
// phase that wrote it, so that a reader that finds its phase in every word
// of a site has the site's value, with no fence between data and flag; 0
// before a launch, and again after it.
__host__ __device__ constexpr size_t ru_l2_words(int N, int Nth) {
  return (static_cast<size_t>(N) * (64 * Nth + 4 * kMreSums) + 1 + 15) / 16 * 16;
}

// Two words at p (16-byte aligned), each stored and loaded whole.
__device__ __forceinline__ void st_words(unsigned long long* p, unsigned long long a,
                                         unsigned long long b) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b) : "memory");
}
__device__ __forceinline__ void ld_words(const unsigned long long* p, unsigned long long& a,
                                         unsigned long long& b) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p) : "memory");
}
// 32 bits of a value under the phase c, and back
__device__ __forceinline__ unsigned long long tagged(unsigned bits, unsigned c) {
  return static_cast<unsigned long long>(c) << 32 | bits;
}
__device__ __forceinline__ unsigned phase_of(unsigned long long w) {
  return static_cast<unsigned>(w >> 32);
}
__device__ __forceinline__ unsigned bits_of(unsigned long long w) {
  return static_cast<unsigned>(w);
}

__device__ __forceinline__ void red_release(unsigned* f, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(f), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  return v;
}
// A spin that traps after ~2^35 cycles instead of hanging
__device__ __forceinline__ void spin_guard(long long t0) {
  if (clock64() - t0 > (1ll << 35)) __trap();
}

// The L2 transport's state in RuCluster<true>: the chain's exchange area
// and the phases the block has reached (the same in every block of the
// chain, which runs the same sequence of exchanges); nothing in the
// cluster's.
template <bool L2>
struct RuXch {};
template <>
struct RuXch<true> {
  unsigned long long* halo;  // [N][4 mailboxes][2 phases][2 rows][Nth][4]
  unsigned long long* sums;  // [N][2 phases][kMreSums][2]
  unsigned* bar;             // the arrivals at the chain's barriers
  unsigned hc[4];            // phases received, by mailbox
  unsigned sc, bc;           // sum phases, barriers passed
};

// The same recursion on N blocks a chain, on one of two transports: a
// thread-block cluster (L2 = false, below) or ordinary blocks that exchange
// through global memory (L2 = true, further below). Block `rank` owns the rows [rank * rows, (rank + 1) * rows) of x of every field
// and holds them, site-major as RuShared does, between two halo rows: row -1
// and row `rows` are the neighbour blocks' edge rows, so a stencil stage
// reads local shared memory only and x needs no wrap. The f64 true residual
// runs through the global scratch, each block its own rows, with a full
// cluster barrier between its stages (2-3 a solve).
//
// The f32 recursion exchanges its data without a cluster barrier: on the
// H100 barrier.cluster.arrive.release blocks its thread ~1150 cycles (the
// release, measured with no store before it; ~1500 cycles a round with the
// wait), six times an iteration, and the arrive and wait split around the
// interior rows only moved that time into the arrive. Instead the thread
// that computes an edge row's site stores it into the neighbour block's halo
// row with st.async, which counts its bytes on an mbarrier of that block; a
// block waits on its own mbarrier for the two halo rows of a stage (~440
// cycles a round when nothing hides it). A stage computes its edge rows
// first, sends them, then computes its interior rows (rows 1 .. rows-2, which
// read the block's own rows only) while the rows travel; the next stage's
// edge rows wait for the neighbours' rows. A sum is the block's, stored by N
// of its threads into every block's slots the same way, and the N block sums
// added in rank order by every thread.
//
// Why every store follows the last read of what it overwrites (a block
// never stores into its own halo rows, and reads one only in an edge phase
// after its wait):
// - within the block, every stage starts with a __syncthreads(), so the
//   previous stage's reads of the block's own rows are done;
// - into a neighbour's halo row of t1 at stage 3: the sender computes it
//   after receiving the neighbour's stage-2 edge row, which the neighbour's
//   thread sent after reading the halo site that stage 3 overwrites (a halo
//   site is read only by the thread of the edge site beside it);
// - into the halo rows of d, of t1 at stage 1 and of t2: the sender stores
//   them after the iteration's sums, which need every block's partials, each
//   formed after that block's last read of those rows. Between two applies
//   of the MRE prologue, without a sum, the next apply's d rows follow the
//   sender's stage-4 wait, which follows the neighbour's stage-3 rows, sent
//   after its stage-1 reads of d;
// - the sums' slots alternate between two sets, and a block stores into a set
//   again only after the sum between, which needs every block's partial,
//   formed after it read that set.
// The same chains of dependence keep an mbarrier from receiving a phase's
// bytes before its previous phase completed. Every block runs the same
// sequence of exchanges, so each mbarrier's parity is the same everywhere.
//
// The L2 transport (L2 = true) keeps that shape with global memory in the
// place of the neighbours' shared memory, a block's halo rows written by the
// block itself, each site by the one thread that reads it. The thread of an
// edge site stores it into its block's slot of the mailbox and phase (which
// alternates, so a slot is rewritten two phases later) as four 8-byte words,
// each a float with the phase above it (ru_l2_words); the thread of the edge
// site beside the halo site loads the four until each holds the phase it
// waits for, and puts the site into the block's halo row before its stage
// reads it. A word is stored and loaded whole, so the phase in it vouches
// for the value beside it: no fence between data and flag, one trip to L2
// once the data is there (a release of a counter after the data, and a
// second load after the acquire, took ~21.7 us an iteration at 128x128 C=32
// on the H100, against 13.3 for one wave of clusters). A sum is the block's,
// stored by thread 0 in two such words; lane i < N of every warp waits for
// block i's, and every thread adds the N sums, shuffled from those lanes, in
// rank order. A full barrier is __syncthreads(), thread 0's red.release.gpu
// on the chain's arrival counter and its ld.acquire.gpu spin to N times the
// barriers passed, then __syncthreads(). The stores follow the last reads of
// what they overwrite by the same chains of dependence. At the end each
// block arrives once more and rank 0 alone waits for the others, then sets
// the chain's area back to 0, so that a phase found in a word is this
// launch's and the next launch needs no zeroing before it.
template <bool L2>
struct RuCluster : RuF64 {
  float* fields;            // the block's dynamic shared memory: 24 Vh floats
  double* csum;             // 2 sets of kRuClusterMax block sums
  unsigned long long* mb;   // kMbars mbarriers of the block (kMbD .. kMbSum + 1)
  BlockSum& sum;
  int N, rank, rows, Vl, Vh;
  int cset;
  unsigned parity;          // bit b: the parity of mbarrier b's current phase
  bool d_sent;              // d's edge rows were sent and not yet waited for
  int sxk[kOwnSites];        // local row << 16 | packed column of each own site
  double x[kOwnSites][4];
  RuXch<L2> xch;

  // the mbarriers: the halo rows of d, of t1 from stage 1, of t2, of t1 from
  // stage 3, and the sums' two slot sets
  static constexpr int kMbD = 0, kMbT1 = 1, kMbT2 = 2, kMbT3 = 3, kMbSum = 4, kMbars = 6;

  // links of 2 Vh float2 a parity, then four spinors of Vh float4 each; Vh
  // sites a field: the block's rows and the two halo rows
  __device__ __forceinline__ float2* ue() const { return reinterpret_cast<float2*>(fields); }
  __device__ __forceinline__ float2* uo() const { return ue() + 2 * Vh; }
  __device__ __forceinline__ float4* d() const {
    return reinterpret_cast<float4*>(fields + 8 * Vh);
  }
  __device__ __forceinline__ float4* r() const { return d() + Vh; }
  __device__ __forceinline__ float4* t1() const { return d() + 2 * Vh; }
  __device__ __forceinline__ float4* t2() const { return d() + 3 * Vh; }

  // own site j of the thread, sl = tid + j * kThreads < Vl, lies at index
  // sl + halo() of a field: local row xl (-1 .. rows), packed column k at
  // (xl + 1) * Nth + k
  __device__ __forceinline__ int halo() const { return g.Nth; }
  __device__ __forceinline__ int row0() const { return rank * rows; }

  // a full barrier of the chain's blocks (the f64 true residual, the start
  // and the end): the release makes the block's global stores visible to
  // the others
  __device__ __forceinline__ void sync() {
    const long long t0 = clock64();
    if constexpr (L2) {
      const unsigned c = N * ++xch.bc;
      __syncthreads();
      if (threadIdx.x == 0) {
        red_release(xch.bar, 1u);
        for (const long long t1 = clock64(); ld_acquire(xch.bar) < c;) spin_guard(t1);
      }
      __syncthreads();
    } else {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    }
    t_wait += clock64() - t0;
  }

  // the L2 transport's words: site k of block r's edge row `row` (0 the
  // first, 1 the last) of mailbox b in phase c; block r's sums of phase c
  __device__ __forceinline__ unsigned long long* site_words(int r, int b, unsigned c, int row,
                                                           int k) const {
    return xch.halo + ((((r * 4 + b) * 2 + static_cast<int>(c & 1u)) * 2 + row) * g.Nth + k) * 4;
  }
  __device__ __forceinline__ unsigned long long* sum_words(int r, unsigned c) const {
    return xch.sums + (r * 2 + static_cast<int>(c & 1u)) * kMreSums * 2;
  }

  // site k of the block's edge row `row`, in the mailbox's next phase
  __device__ __forceinline__ void give(int b, int row, int k, float4 v) const {
    const unsigned c = xch.hc[b] + 1;
    unsigned long long* w = site_words(rank, b, c, row, k);
    st_words(w, tagged(__float_as_uint(v.x), c), tagged(__float_as_uint(v.y), c));
    st_words(w + 2, tagged(__float_as_uint(v.z), c), tagged(__float_as_uint(v.w), c));
  }
  // site k of block r's edge row `row` in phase c, once every word holds it
  __device__ __forceinline__ float4 take(int r, int b, int row, int k, unsigned c) {
    const unsigned long long* w = site_words(r, b, c, row, k);
    unsigned long long w0, w1, w2, w3;
    const long long t0 = clock64();
    for (;;) {
      ld_words(w, w0, w1);
      ld_words(w + 2, w2, w3);
      if (phase_of(w0) == c && phase_of(w1) == c && phase_of(w2) == c && phase_of(w3) == c)
        break;
      spin_guard(t0);
    }
    t_wait += clock64() - t0;
    return make_float4(__uint_as_float(bits_of(w0)), __uint_as_float(bits_of(w1)),
                       __uint_as_float(bits_of(w2)), __uint_as_float(bits_of(w3)));
  }
  // the next phase of mailbox b into the halo rows of its field, each halo
  // site by the thread of the edge site beside it (the only one that reads
  // it)
  __device__ __forceinline__ void fetch(int b) {
    const unsigned c = ++xch.hc[b];
    float4* f = b == kMbD ? d() : b == kMbT2 ? t2() : t1();
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      if (threadIdx.x + j * kThreads < Vl && edge(j)) {
        const int xl = sxk[j] >> 16, k = sxk[j] & 0xffff;
        if (xl == 0) f[k] = take((rank + N - 1) % N, b, 1, k, c);
        if (xl == rows - 1) f[(rows + 1) * g.Nth + k] = take((rank + 1) % N, b, 0, k, c);
      }
    }
  }
  // sum v of the block in phase c (thread 0)
  __device__ __forceinline__ void give_sum(int v, unsigned c, double x) const {
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(x));
    st_words(sum_words(rank, c) + 2 * v, tagged(static_cast<unsigned>(bits), c),
             tagged(static_cast<unsigned>(bits >> 32), c));
  }
  // sum v of phase c over the chain's blocks: lane i < N of each warp
  // waits for block i's, and every lane adds the N in rank order
  __device__ __forceinline__ double chain_sum(int v, unsigned c) {
    const int lane = threadIdx.x & 31;
    const long long t0 = clock64();
    double mine = 0.0;
    if (lane < N) {
      const unsigned long long* w = sum_words(lane, c) + 2 * v;
      unsigned long long lo, hi;
      for (;;) {
        ld_words(w, lo, hi);
        if (phase_of(lo) == c && phase_of(hi) == c) break;
        spin_guard(t0);
      }
      mine = __longlong_as_double(static_cast<long long>(
          static_cast<unsigned long long>(bits_of(hi)) << 32 | bits_of(lo)));
    }
    double all = 0.0;
    for (int i = 0; i < N; ++i) all += __shfl_sync(0xffffffffu, mine, i);
    t_wait += clock64() - t0;
    return all;
  }

  static __device__ __forceinline__ unsigned smem(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
  }
  // the address of the block's shared location a in block r of the cluster
  static __device__ __forceinline__ unsigned in_block(unsigned a, int r) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(r));
    return out;
  }
  __device__ __forceinline__ unsigned mbar(int b) const { return smem(mb + b); }

  // the mbarriers, before the cluster barrier that every block passes before
  // its first exchange
  __device__ __forceinline__ void init_mbars() const {
    if (!L2 && threadIdx.x == 0) {
      for (int b = 0; b < kMbars; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar(b)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  // Wait for the current phase of mbarrier b: thread 0 arms it with the bytes
  // the phase receives (the two halo rows, or a block sum from each block);
  // the threads that read what it brings wait. Every thread flips the parity.
  // A phase that never completes traps after ~2^35 cycles instead of hanging.
  __device__ __forceinline__ void wait_for(int b, bool reader) {
    wait_bytes(b, reader, b >= kMbSum ? 8 * N : 2 * 16 * g.Nth);
  }
  __device__ __forceinline__ void wait_bytes(int b, bool reader, int bytes) {
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar(b)),
                   "r"(bytes)
                   : "memory");
    if (reader) {
      const long long t0 = clock64();
      unsigned done = 0;
      while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(mbar(b)), "r"((parity >> b) & 1u)
            : "memory");
        if (!done && clock64() - t0 > (1ll << 35)) __trap();
      }
      t_wait += clock64() - t0;
    }
    parity ^= 1u << b;
  }

  // v into the float4 at the block's shared location a, in block r, counted
  // on that block's mbarrier b
  __device__ __forceinline__ void send(const float4* a, int r, int b, float4 v) const {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(in_block(smem(a), r)),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(in_block(mbar(b), r))
        : "memory");
  }
  __device__ __forceinline__ void send(const double* a, int r, int b, double v) const {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
            in_block(smem(a), r)),
        "l"(__double_as_longlong(v)), "r"(in_block(mbar(b), r))
        : "memory");
  }

  // whether own site j lies in one of the block's two edge rows, the rows
  // whose stencil reads a halo row; a thread with such a site waits for the
  // halo rows
  __device__ __forceinline__ bool edge(int j) const {
    const int xl = sxk[j] >> 16;
    return xl == 0 || xl == rows - 1;
  }
  __device__ __forceinline__ bool edge_thread() const {
    bool e = false;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) e |= threadIdx.x + j * kThreads < Vl && edge(j);
    return e;
  }

  // One stencil stage: a __syncthreads() for the block's own rows of the
  // previous stage, the wait for its halo rows (mbarrier b) by the edge
  // threads, f(true) at the edge rows (which sends them), f(false) at the
  // interior rows while they travel.
  template <class F>
  __device__ __forceinline__ void split_stage(int b, F f) {
    __syncthreads();
    if constexpr (L2) {
      fetch(b);
    } else {
      wait_for(b, edge_thread());
      if (b == kMbD) d_sent = false;
    }
    f(true);
    f(false);
  }

  // the first three stages of A d, with d stored and its edge rows sent:
  // t1 = (H_eo)^+ d, t2 = Dhat^+ d, t1 = H_oe t2
  __device__ __forceinline__ void three_stages() {
    split_stage(kMbD, [&](bool e) {
      stage<true, false>(uo(), ue(), d(), 1, t1(), kMbT1, nullptr, 0.f, 0.f, e);
    });
    split_stage(kMbT1, [&](bool e) {
      stage<true, true>(ue(), uo(), t1(), 0, t2(), kMbT2, d(), m, -c, e);
    });
    split_stage(kMbT2, [&](bool e) {
      stage<false, false>(uo(), ue(), t2(), 1, t1(), kMbT3, nullptr, 0.f, 0.f, e);
    });
  }

  // the fourth stage at own site j (index h): Dhat t2 = m t2 - c H_oe t1
  __device__ __forceinline__ float4 dhat_site(int j, int h) const {
    Cx<float> h0, h1;
    hop_site_shared<false>(ue(), uo(), t1(), h, nbrs(j, h, 0), Vh, h0, h1);
    const float4 vs = t2()[h];
    h0 = axpby(m, lo(vs), -c, h0);
    h1 = axpby(m, hi(vs), -c, h1);
    return f4(h0, h1);
  }

  // the links of the block's rows and of its halo rows, from the angles
  __device__ __forceinline__ void make_links_rows(const float* __restrict__ th, int parity,
                                                  float2* u) const {
    for (int h = threadIdx.x; h < Vh; h += kThreads) {
      const int xl = h / g.Nth - 1;
      const int k = h - (xl + 1) * g.Nth;
      const int gx = (row0() + xl + g.Nx) % g.Nx;
      const bool flip = ((gx + parity) & 1) && (k == g.Nth - 1);
      for (int mu = 0; mu < 2; ++mu) {
        float sn, cs;
        sincosf(th[mu * g.V2 + gx * g.Nth + k], &sn, &cs);
        if (mu == 0 && flip) {
          sn = -sn;
          cs = -cs;
        }
        u[mu * Vh + h] = make_float2(cs, sn);
      }
    }
  }

  __device__ __forceinline__ void init_sites() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      const int xl = sl / g.Nth;
      sxk[j] = (xl << 16) | (sl - xl * g.Nth);
    }
  }

  __device__ __forceinline__ void init(const float* x0) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      const int xl = sl / g.Nth;
      sxk[j] = (xl << 16) | (sl - xl * g.Nth);
      if (sl < Vl) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[j][q] = static_cast<double>(x0[q * g.V2 + row0() * g.Nth + sl]);
      }
    }
  }

  // sum over the chain's blocks, the same bits in every thread of each
  __device__ __forceinline__ double cluster_sum(double v) {
    const double tot = sum(v);
    if constexpr (L2) {
      const unsigned c = ++xch.sc;
      if (threadIdx.x == 0) give_sum(0, c, tot);
      return chain_sum(0, c);
    }
    const int b = kMbSum + cset;
    double* slot = csum + cset * kRuClusterMax;
    cset ^= 1;
    if (threadIdx.x < N) send(slot + rank, threadIdx.x, b, tot);
    wait_for(b, true);
    double all = 0.0;
    for (int i = 0; i < N; ++i) all += slot[i];
    return all;
  }

  // the halo rows of d that the last update sent, before the block leaves
  __device__ __forceinline__ void drain() {
    if (d_sent) wait_for(kMbD, edge_thread());
    d_sent = false;
  }

  // After the loop: x64 written out by every block before rank 0, which
  // alone goes on (ru_finish), reads it. The cluster's blocks wait for the
  // halo rows in flight and pass a full barrier; on L2 each block arrives
  // and rank 0 waits for the others, then sets the chain's exchange area
  // back to 0 (no block reads it any more).
  __device__ __forceinline__ void end() {
    if constexpr (L2) {
      write_x64();
      const unsigned c = N * (xch.bc + 1);
      __syncthreads();
      if (threadIdx.x == 0) red_release(xch.bar, 1u);
      if (rank != 0) return;
      if (threadIdx.x == 0) {
        const long long t0 = clock64();
        while (ld_acquire(xch.bar) < c) spin_guard(t0);
        t_wait += clock64() - t0;
      }
      __syncthreads();
      ulonglong2* w = reinterpret_cast<ulonglong2*>(xch.halo);
      for (int i = threadIdx.x; i < static_cast<int>(ru_l2_words(N, g.Nth) / 2); i += kThreads)
        w[i] = make_ulonglong2(0ull, 0ull);
    } else {
      drain();
      write_x64();
      sync();
    }
  }

  // the MRE prologue's pieces (mre_forecast), as RuShared's but r1 in
  // registers (the apply uses t2); s is the own site's planar index in the
  // chain's lattice
  using A0 = OwnSmem;
  using R1 = OwnRegs;
  using W = OwnRegs;
  template <class F>
  __device__ __forceinline__ void each_own(F f) const {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < Vl) f(j, row0() * g.Nth + sl);
    }
  }
  __device__ __forceinline__ OwnSmem stash_a0() const { return {r(), halo() - row0() * g.Nth}; }
  __device__ __forceinline__ OwnRegs stash_r1() const { return {}; }
  __device__ __forceinline__ OwnRegs stash_w(int) const { return {}; }
  __device__ __forceinline__ void set_x(int j, int, const double (&v)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[j][q] = v[q];
  }

  // The first M of the prologue's sums over the chain: the block's, as
  // block_sums adds them, stored by N M of its threads into every block's
  // slots cs[v * kRuClusterMax + rank] as cluster_sum stores one, counted on
  // the sums' next mbarrier, and the N block sums of each added in rank order
  // by every thread. The slots are used once a launch.
  __device__ __forceinline__ void chain_sums(const double* slots, double* cs, int M,
                                             double (&out)[kMreSums]) {
    __syncthreads();
    if constexpr (L2) {
      const unsigned c = ++xch.sc;
      if (threadIdx.x == 0)
        for (int v = 0; v < M; ++v) give_sum(v, c, warp_partials_sum(slots + v * kWarps));
#pragma unroll
      for (int v = 0; v < kMreSums; ++v) out[v] = v < M ? chain_sum(v, c) : 0.0;
      return;
    }
    const int b = kMbSum + cset;
    cset ^= 1;
    if (threadIdx.x < N * M) {
      const int v = threadIdx.x % M;
      send(cs + v * kRuClusterMax + rank, threadIdx.x / M, b,
           warp_partials_sum(slots + v * kWarps));
    }
    wait_bytes(b, true, 8 * N * M);
#pragma unroll
    for (int v = 0; v < kMreSums; ++v) {
      double all = 0.0;
      if (v < M)
        for (int i = 0; i < N; ++i) all += cs[v * kRuClusterMax + i];
      out[v] = all;
    }
  }

  // f(j, s, A src) at the block's rows, as RuShared::apply_A_own, the edge
  // rows of each stage also sent into the neighbours' halo rows
  template <class F>
  __device__ __forceinline__ void apply_A_own(const float* src, F f) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads, s = row0() * g.Nth + sl;
      if (sl < Vl)
        put(d(), sl, kMbD,
            make_float4(src[s], src[g.V2 + s], src[2 * g.V2 + s], src[3 * g.V2 + s]));
    }
    three_stages();
    split_stage(kMbT3, [&](bool e) {
#pragma unroll
      for (int j = 0; j < kOwnSites; ++j) {
        const int sl = threadIdx.x + j * kThreads;
        if (sl < Vl && edge(j) == e) f(j, row0() * g.Nth + sl, dhat_site(j, sl + halo()));
      }
    });
  }

  // store own site sl of a field, and send a site of an edge row into the
  // neighbour block's halo row, counted on its mbarrier b: the first row is
  // the previous block's row `rows`, the last row the next block's row -1
  __device__ __forceinline__ void put(float4* f, int sl, int b, float4 v) {
    const int h = sl + halo();
    f[h] = v;
    if constexpr (L2) {
      if (sl < g.Nth) give(b, 0, sl, v);
      if (sl >= Vl - g.Nth) give(b, 1, sl - (Vl - g.Nth), v);
    } else {
      if (sl < g.Nth) send(f + h + Vl, (rank + N - 1) % N, b, v);
      if (sl >= Vl - g.Nth) send(f + h - Vl, (rank + 1) % N, b, v);
      if (b == kMbD) d_sent = true;
    }
  }

  // neighbours of own site j at index h
  __device__ __forceinline__ Nbr nbrs(int j, int h, int tgt_parity) const {
    const int k = sxk[j] & 0xffff;
    const int off = (row0() + (sxk[j] >> 16) + tgt_parity) & 1;
    Nbr n;
    n.pt = off ? (k + 1 == g.Nth ? h - k : h + 1) : h;
    n.mt = off ? h : (k == 0 ? h + g.Nth - 1 : h - 1);
    n.px = h + g.Nth;
    n.mx = h - g.Nth;
    return n;
  }

  // out = hop(S), or a*v + bb*hop(S), at the own sites in the edge rows
  // (edges; sent on mbarrier b) or in the interior rows
  template <bool DAG, bool AXPBY>
  __device__ __forceinline__ void stage(const float2* Ut, const float2* Us, const float4* S,
                                        int tgt_parity, float4* out, int b, const float4* v,
                                        float a, float bb, bool edges) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads, h = sl + halo();
      if (sl < Vl && edge(j) == edges) {
        Cx<float> h0, h1;
        hop_site_shared<DAG>(Ut, Us, S, h, nbrs(j, h, tgt_parity), Vh, h0, h1);
        if (AXPBY) {
          const float4 vs = v[h];
          h0 = axpby(a, lo(vs), bb, h0);
          h1 = axpby(a, hi(vs), bb, h1);
        }
        put(out, sl, b, make_float4(h0.re, h0.im, h1.re, h1.im));
      }
    }
  }

  __device__ __forceinline__ float bnorm2() {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < Vl) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const double bi = b[q * g.V2 + row0() * g.Nth + sl];
          acc += bi * bi;
        }
      }
    }
    return static_cast<float>(cluster_sum(acc));
  }

  __device__ __forceinline__ float true_residual() {
    const long long t0 = clock64();
    const int lo_s = row0() * g.Nth, hi_s = lo_s + Vl;
    write_x64();
    // normal_apply, each block its rows
    sync();
    hop_stage_range<double, true>(uo64, ue64, x64, 1, u1, nullptr, 0.0, 0.0, g, lo_s, hi_s);
    sync();
    hop_stage_range<double, true>(ue64, uo64, u1, 0, u2, x64, m64, -c64, g, lo_s, hi_s);
    sync();
    hop_stage_range<double, false>(uo64, ue64, u2, 1, u1, nullptr, 0.0, 0.0, g, lo_s, hi_s);
    sync();
    hop_stage_range<double, false>(ue64, uo64, u1, 0, Ax, u2, m64, -c64, g, lo_s, hi_s);
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < Vl) {
        float ri[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = q * g.V2 + lo_s + sl;
          ri[q] = static_cast<float>(static_cast<double>(b[i]) - Ax[i]);
          acc += static_cast<double>(ri[q]) * static_cast<double>(ri[q]);
        }
        r()[sl + halo()] = make_float4(ri[0], ri[1], ri[2], ri[3]);
      }
    }
    const float rho = static_cast<float>(cluster_sum(acc));
    t_res += clock64() - t0;
    return rho;
  }

  __device__ __forceinline__ void restart_from_zero() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < Vl) {
        const int gs = row0() * g.Nth + sl;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[j][q] = 0.0;
        r()[sl + halo()] =
            make_float4(b[gs], b[g.V2 + gs], b[2 * g.V2 + gs], b[3 * g.V2 + gs]);
      }
    }
  }

  __device__ __forceinline__ void d_from_r() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < Vl) put(d(), sl, kMbD, r()[sl + halo()]);
    }
  }

  // Ad in t2's place, as RuShared::apply_dAd; d was stored and sent by
  // update_d or d_from_r. The fourth stage reads t2 only at the site it
  // stores, so the edge rows' Ad does not disturb the interior rows'. The
  // <d, Ad> partial is added after both, own site by own site as one pass
  // would add it.
  __device__ __forceinline__ float apply_dAd() {
    three_stages();
    split_stage(kMbT3, [&](bool e) {
#pragma unroll
      for (int j = 0; j < kOwnSites; ++j) {
        const int sl = threadIdx.x + j * kThreads, h = sl + halo();
        if (sl < Vl && edge(j) == e) t2()[h] = dhat_site(j, h);
      }
    });
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int h = threadIdx.x + j * kThreads + halo();
      if (h < Vl + halo()) {
        const float4 as = t2()[h], ds = d()[h];
        acc += static_cast<double>(ds.x) * static_cast<double>(as.x);
        acc += static_cast<double>(ds.y) * static_cast<double>(as.y);
        acc += static_cast<double>(ds.z) * static_cast<double>(as.z);
        acc += static_cast<double>(ds.w) * static_cast<double>(as.w);
      }
    }
    return static_cast<float>(cluster_sum(acc));
  }

  __device__ __forceinline__ float update_x_r(float alpha) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int h = threadIdx.x + j * kThreads + halo();
      if (h < Vl + halo()) {
        const float4 ds = d()[h], as = t2()[h], rs = r()[h];
        const float dq[4] = {ds.x, ds.y, ds.z, ds.w}, aq[4] = {as.x, as.y, as.z, as.w};
        float rq[4] = {rs.x, rs.y, rs.z, rs.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[j][q] = fma_rn(static_cast<double>(alpha), static_cast<double>(dq[q]), x[j][q]);
          rq[q] = fma_rn(-alpha, aq[q], rq[q]);
          acc += static_cast<double>(rq[q]) * static_cast<double>(rq[q]);
        }
        r()[h] = make_float4(rq[0], rq[1], rq[2], rq[3]);
      }
    }
    return static_cast<float>(cluster_sum(acc));
  }

  // every block is past both sums of the iteration, so none still reads
  // the old d at a neighbour or in a halo row
  __device__ __forceinline__ void update_d(float beta) {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads, h = sl + halo();
      if (sl < Vl) {
        const float4 ds = d()[h], rs = r()[h];
        put(d(), sl, kMbD, make_float4(fma_rn(beta, ds.x, rs.x), fma_rn(beta, ds.y, rs.y),
                                 fma_rn(beta, ds.z, rs.z), fma_rn(beta, ds.w, rs.w)));
      }
    }
  }

  __device__ __forceinline__ void write_x64() {
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < Vl) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x64[q * g.V2 + row0() * g.Nth + sl] = x[j][q];
      }
    }
  }
};

// Re<u, w> of two spinors at one site, in f64
__device__ __forceinline__ double dot4(float4 u, float4 w) {
  return static_cast<double>(u.x) * static_cast<double>(w.x) +
         static_cast<double>(u.y) * static_cast<double>(w.y) +
         static_cast<double>(u.z) * static_cast<double>(w.z) +
         static_cast<double>(u.w) * static_cast<double>(w.w);
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// The forecast's coefficients c_1 .. c_n (n = K - 1; c[i - 1]) from its sums
// gs (direction i's at mre_sums(i): <w_i, w_1> .. <w_i, w_i>, <r1, w_i>): the
// least-squares solution of min |r1 - sum_i c_i w_i| by the Cholesky factor
// R of the Gram matrix, R^T y = <r1, w>, R c = y, with 1 / R_ii in inv.
// R_ii^2 is the squared Schmidt norm of w_i against the directions kept
// before it, MGS's |w|^2; a direction where it is not above 1e-8 of the
// largest so far is dropped (inv_i 0: its row of R, y_i and c_i 0), as MGS
// drops it. In f64, the same bits in every thread.
__device__ __forceinline__ void mre_solve(const double (&gs)[kMreSums], int n,
                                          double (&c)[kMreMax - 1]) {
  constexpr int kN = kMreMax - 1;
  double R[kN][kN], inv[kN], y[kN];
  double largest = 0.0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int row = mre_sums(i + 1);
    double nrm = gs[row + i], yi = gs[row + i + 1];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      double rji = gs[row + j];
#pragma unroll
      for (int k = 0; k < j; ++k) rji -= R[k][j] * R[k][i];
      rji *= inv[j];
      R[j][i] = rji;
      nrm -= rji * rji;
      yi -= rji * y[j];
    }
    largest = i == 0 ? nrm : fmax(largest, nrm);
    inv[i] = i < n && nrm > 1e-8 * largest ? rsqrt(nrm) : 0.0;
    y[i] = yi * inv[i];
  }
#pragma unroll
  for (int i = kN - 1; i >= 0; --i) {
    double ci = y[i];
#pragma unroll
    for (int j = i + 1; j < kN; ++j) ci -= R[i][j] * c[j];
    c[i] = ci * inv[i];
  }
}

// The MRE forecast of one chain (2 <= K <= kMreMax; pallas_df.py:454-492) on
// a store of its vectors, into the store's x (S.set_x): A hist[0], then for
// each older solution w_i = A hist[i] - A hist[0] and its sums with r1 =
// b - A hist[0] and with the w_j before it, in f32 at the thread's own sites
// with each product added in f64 (kept where the store keeps them: A hist[0],
// r1, w_1 .. w_{K-2}); after each apply the warps' partials of its i + 1
// sums into `slots` (kWarps a sum); one chain sum of all; the coefficients
// (mre_solve); x0 = hist[0] + sum_i c_i (hist[i] - hist[0]) in f64.
// slots: kMreSums * kWarps doubles of shared memory; cs: the cluster's
// kMreSums * kRuClusterMax slots.
template <class Store>
__device__ void mre_forecast(Store& S, const RuParams& p, int ch, double* slots, double* cs) {
  const int V2 = S.g.V2, n = 4 * V2;
  const size_t step = static_cast<size_t>(p.C) * n;  // hist[i] to hist[i + 1]
  const float* h0 = p.hist + static_cast<size_t>(ch) * n;
  const float* b = S.b;
  typename Store::A0 a0 = S.stash_a0();
  typename Store::R1 r1 = S.stash_r1();
  typename Store::W w_kept[kMreMax - 2];  // w_1 .. w_{K-2}
#pragma unroll
  for (int i = 0; i < kMreMax - 2; ++i) w_kept[i] = S.stash_w(i);
  S.apply_A_own(h0, [&](int j, int s, float4 a) {
    a0.set(j, s, a);
    r1.set(j, s, sub4(make_float4(b[s], b[V2 + s], b[2 * V2 + s], b[3 * V2 + s]), a));
  });
#pragma unroll
  for (int i = 1; i < kMreMax; ++i) {
    if (i < p.K) {
      double acc[kMreMax] = {};  // <w_i, w_1> .. <w_i, w_i>, <r1, w_i>
      S.apply_A_own(h0 + i * step, [&](int j, int s, float4 a) {
        const float4 w = sub4(a, a0.get(j, s));
#pragma unroll
        for (int k = 1; k < i; ++k) acc[k - 1] += dot4(w, w_kept[k - 1].get(j, s));
        acc[i - 1] += dot4(w, w);
        acc[i] += dot4(r1.get(j, s), w);
        if (i < kMreMax - 1 && i + 1 < p.K) w_kept[i - 1].set(j, s, w);
      });
#pragma unroll
      for (int v = 0; v <= i; ++v) warp_slot(acc[v], slots + (mre_sums(i) + v) * kWarps);
    }
  }
  double gs[kMreSums], c[kMreMax - 1];
  S.chain_sums(slots, cs, mre_sums(p.K), gs);
  mre_solve(gs, p.K - 1, c);
  // the loads unconditional (hist[0] in the place of an entry past K), so
  // that they are in flight together; a dropped direction leaves x as it is
  S.each_own([&](int j, int s) {
    double x0[4], x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x0[q] = x[q] = h0[q * V2 + s];
#pragma unroll
    for (int i = 1; i < kMreMax; ++i) {
      const float* h = h0 + (i < p.K ? i * step : 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const double xi = fma(c[i - 1], static_cast<double>(h[q * V2 + s]) - x0[q], x[q]);
        x[q] = c[i - 1] != 0.0 ? xi : x[q];
      }
    }
    S.set_x(j, s, x);
  });
}

// The MRE prologue's cycles since t0, added into the clocks' fourth column
// by the chain's first thread (`first`) as the prologue ends, so that the
// K = 1 path keeps no value of its own across the loop.
__device__ __forceinline__ void mre_clock(const RuParams& p, int ch, long long t0, bool first) {
  if (first && p.clocks != nullptr) p.clocks[4 * ch + 3] += clock64() - t0;
}

// What follows the loop on every path: the chain's outputs and, for a chain
// left unconverged when the caller asked for it, the f64 fallback from x64
// (already written). fbw: the fallback's scratch.
__device__ __forceinline__ void ru_finish(const RuParams& p, const RuF64& f, int ch, int iters,
                                          bool conv, long long t_begin, double* fbw,
                                          BlockSum& sum) {
  const int n = 4 * f.g.V2;
  float* xo = p.x + (size_t)ch * n;
  for (int i = threadIdx.x; i < n; i += kThreads) xo[i] = static_cast<float>(f.x64[i]);
  if (threadIdx.x == 0) {
    p.iters[ch] = iters;
    p.fb_iters[ch] = 0;
    p.conv[ch] = conv ? 1 : 0;
    if (p.clocks != nullptr) {  // added, so that one buffer sums a run's launches
      p.clocks[4 * ch] += clock64() - t_begin;
      p.clocks[4 * ch + 1] += f.t_res;
      p.clocks[4 * ch + 2] += f.t_wait;
    }
  }
  if (conv || !p.fallback) return;
  const FbOut fb = cg_fallback_chain(f.ue64, f.uo64, f.b, f.x64, xo, fbw, p.m0, p.tol, p.tau,
                                     p.fb_max_iter, p.fb_max_rounds, f.g, sum);
  if (threadIdx.x == 0) {
    p.iters[ch] = iters + fb.iters;
    p.fb_iters[ch] = fb.iters;
    p.conv[ch] = fb.conv;
  }
}

__device__ __forceinline__ RuF64 ru_f64(const RuParams& p, int ch, const Geo& g, double* f64) {
  const int V2 = g.V2;
  return {p.b + (size_t)ch * 4 * V2,
          p.x64 + (size_t)ch * 4 * V2,
          f64,
          f64 + 4 * V2,
          f64 + 8 * V2,
          f64 + 12 * V2,
          f64 + 16 * V2,
          g,
          static_cast<float>(p.m0 + 2.0),
          static_cast<float>(1.0 / (4.0 * (p.m0 + 2.0))),
          p.m0 + 2.0,
          1.0 / (4.0 * (p.m0 + 2.0)),
          0,
          0};
}

// The kernels of a launch with a history (MRE: the prologue, K >= 2) and
// without (K = 1), so that the K = 1 kernels hold no prologue.
template <bool MRE>
__global__ void __launch_bounds__(kThreads, 1) solve_ru_shared_kernel(const RuParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[2 * (kThreads / 32)];
  const long long t_begin = clock64();
  const Geo g{p.Nx, p.Nth, p.Nx * p.Nth};
  const int V2 = g.V2, ch = blockIdx.x;
  BlockSum sum{sh, 0};
  double* scratch = p.s64 + (size_t)ch * ru_s64_values(p.f64_shared, p.fallback) * V2;
  double* f64 = p.f64_shared ? reinterpret_cast<double*>(smem + 24 * V2) : scratch;
  float4* planes = reinterpret_cast<float4*>(smem + 8 * V2);
  RuShared S{ru_f64(p, ch, g, f64),
             reinterpret_cast<float2*>(smem),
             reinterpret_cast<float2*>(smem + 4 * V2),
             planes,
             planes + V2,
             planes + 2 * V2,
             planes + 3 * V2,
             sum};
  make_links_shared(p.thE + (size_t)ch * 2 * V2, 0, S.ue, g);
  make_links_shared(p.thO + (size_t)ch * 2 * V2, 1, S.uo, g);
  make_links<double>(p.thE + (size_t)ch * 2 * V2, 0, S.ue64, g);
  make_links<double>(p.thO + (size_t)ch * 2 * V2, 1, S.uo64, g);
  if constexpr (MRE) {
    __shared__ double slots[kMreSums * kWarps];
    const long long t0 = clock64();
    S.init_sites();
    mre_forecast(S, p, ch, slots, nullptr);
    mre_clock(p, ch, t0, threadIdx.x == 0);
  } else {
    S.init(p.hist + (size_t)ch * 4 * V2);
  }

  int iters;
  const bool conv = ru_loop(S, p, iters);
  S.write_x64();
  __syncthreads();
  ru_finish(p, S, ch, iters, conv, t_begin, p.f64_shared ? scratch : scratch + 8 * V2, sum);
}

// One chain on N blocks (N divides Nx, and a block's rows hold at most
// kOwnSites * kThreads sites), block `rank` of them, on either transport.
template <bool MRE, bool L2>
__device__ __forceinline__ void ru_blocks_solve(const RuParams& p, long long t_begin, int N,
                                                int rank) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[2 * (kThreads / 32)];
  __shared__ double csum[2 * kRuClusterMax];
  __shared__ unsigned long long mb[RuCluster<L2>::kMbars];
  const Geo g{p.Nx, p.Nth, p.Nx * p.Nth};
  const int V2 = g.V2, ch = blockIdx.x / N;
  const int rows = p.Nx / N, Vl = rows * p.Nth, Vh = (rows + 2) * p.Nth;
  BlockSum sum{sh, 0};
  double* scratch = p.s64 + (size_t)ch * ru_s64_values(false, p.fallback) * V2;
  RuCluster<L2> S{ru_f64(p, ch, g, scratch), smem, csum, mb, sum, N, rank, rows, Vl, Vh, 0, 0u,
                  false};
  if constexpr (L2) {
    unsigned long long* w = p.xch + ch * ru_l2_words(N, p.Nth);
    S.xch = {w, w + 64 * N * p.Nth,
             reinterpret_cast<unsigned*>(w + N * (64 * p.Nth + 4 * kMreSums))};
  }
  S.init_mbars();
  const float* thE = p.thE + (size_t)ch * 2 * V2;
  const float* thO = p.thO + (size_t)ch * 2 * V2;
  S.make_links_rows(thE, 0, S.ue());
  S.make_links_rows(thO, 1, S.uo());
  // the f64 links of the block's own rows; the other blocks' rows are
  // visible after the first sync
  make_links_range<double>(thE, 0, S.ue64, g, rank * Vl, (rank + 1) * Vl);
  make_links_range<double>(thO, 1, S.uo64, g, rank * Vl, (rank + 1) * Vl);
  // every block of the chain runs, with its mbarriers set up, before any
  // writes into another's halo
  S.sync();
  if constexpr (MRE) {
    __shared__ double slots[kMreSums * kWarps], cs[kMreSums * kRuClusterMax];
    const long long t0 = clock64();
    S.init_sites();
    mre_forecast(S, p, ch, slots, cs);
    mre_clock(p, ch, t0, rank == 0 && threadIdx.x == 0);
  } else {
    S.init(p.hist + (size_t)ch * 4 * V2);
  }

  int iters;
  const bool conv = ru_loop(S, p, iters);
  S.end();
  if (rank == 0) ru_finish(p, S, ch, iters, conv, t_begin, scratch + 8 * V2, sum);
}

// One chain per cluster of N blocks (the launch's cluster dimension).
template <bool MRE>
__global__ void __launch_bounds__(kThreads, 1) solve_ru_cluster_kernel(const RuParams p) {
  const long long t_begin = clock64();
  ru_blocks_solve<MRE, false>(p, t_begin, cg::this_cluster().num_blocks(),
                              cg::this_cluster().block_rank());
}

// One chain per p.blocks consecutive blocks of a cooperative launch, which
// exchange through L2.
template <bool MRE>
__global__ void __launch_bounds__(kThreads, 1) solve_ru_l2_kernel(const RuParams p) {
  const long long t_begin = clock64();
  ru_blocks_solve<MRE, true>(p, t_begin, p.blocks, blockIdx.x % p.blocks);
}

template <bool MRE>
__global__ void __launch_bounds__(kThreads) solve_ru_global_kernel(const RuParams p) {
  __shared__ double sh[2 * (kThreads / 32)];
  const long long t_begin = clock64();
  const Geo g{p.Nx, p.Nth, p.Nx * p.Nth};
  const int V2 = g.V2, n = 4 * V2, ch = blockIdx.x;
  BlockSum sum{sh, 0};
  double* scratch = p.s64 + (size_t)ch * ru_s64_values(false, p.fallback) * V2;
  float* s32 = p.s32 + (size_t)ch * 28 * V2;
  RuGlobal S{ru_f64(p, ch, g, scratch),
             s32,
             s32 + 4 * V2,
             s32 + 8 * V2,
             s32 + 12 * V2,
             s32 + 16 * V2,
             s32 + 20 * V2,
             s32 + 24 * V2,
             n,
             sum};
  make_links<float>(p.thE + (size_t)ch * 2 * V2, 0, S.ue, g);
  make_links<float>(p.thO + (size_t)ch * 2 * V2, 1, S.uo, g);
  make_links<double>(p.thE + (size_t)ch * 2 * V2, 0, S.ue64, g);
  make_links<double>(p.thO + (size_t)ch * 2 * V2, 1, S.uo64, g);
  if constexpr (MRE) {
    __shared__ double slots[kMreSums * kWarps];
    const long long t0 = clock64();
    mre_forecast(S, p, ch, slots, nullptr);
    mre_clock(p, ch, t0, threadIdx.x == 0);
  } else {
    const float* x0 = p.hist + (size_t)ch * n;
    for (int i = threadIdx.x; i < n; i += kThreads) S.x64[i] = static_cast<double>(x0[i]);
  }

  int iters;
  const bool conv = ru_loop(S, p, iters);
  ru_finish(p, S, ch, iters, conv, t_begin, scratch + 8 * V2, sum);
}

}  // namespace sm

namespace {

// The dynamic shared memory of K3's kernel on `path` (0: none), or false
// where the path does not hold an Nx x 2 Nth lattice on n blocks a chain
bool ru_shared_bytes(int path, int Nx, int Nth, int n, size_t& bytes) {
  const size_t V2 = static_cast<size_t>(Nx) * Nth;
  if (path == 0) {
    bytes = 0;
    return true;
  }
  if (path == 1 || path == 2) {
    bytes = sizeof(float) * 24 * V2 + (path == 2 ? sizeof(double) * 20 * V2 : 0);
    return V2 <= sm::kOwnSites * sm::kThreads && bytes <= sm::kSharedMax;
  }
  // path 3 or 4: each block with its rows of x and two halo rows
  if ((path != 3 && path != 4) || n < 2 || n > sm::kRuClusterMax || Nx % n != 0) return false;
  const size_t rows = Nx / n;
  bytes = sizeof(float) * 24 * (rows + 2) * Nth;
  return rows * Nth <= sm::kOwnSites * sm::kThreads && bytes <= sm::kSharedMax;
}

// K3's K = 1 or MRE kernel on `path`
const void* ru_kernel(int path, bool mre) {
  switch (path) {
    case 0:
      return mre ? (const void*)sm::solve_ru_global_kernel<true>
                 : (const void*)sm::solve_ru_global_kernel<false>;
    case 1:
    case 2:
      return mre ? (const void*)sm::solve_ru_shared_kernel<true>
                 : (const void*)sm::solve_ru_shared_kernel<false>;
    case 3:
      return mre ? (const void*)sm::solve_ru_cluster_kernel<true>
                 : (const void*)sm::solve_ru_cluster_kernel<false>;
    default:
      return mre ? (const void*)sm::solve_ru_l2_kernel<true>
                 : (const void*)sm::solve_ru_l2_kernel<false>;
  }
}

}  // namespace

// thE, thO: f32 [C, 2, Nx, Nth]; b, x: f32 and x64: f64 [C, 2, 2, Nx, Nth];
// hist: f32 [K, C, 2, 2, Nx, Nth], 1 <= K <= kMreMax, the start (K = 1) or
// the MRE history, newest first; iters, fb_iters: int32 [C]; conv: one byte
// per chain; clocks: null or int64 [C, 4], to which each chain's cycles
// (total, true residuals, rank 0's thread 0 waiting on the other blocks of
// its chain, that thread in the MRE prologue) are added.
// path 0: every vector in the scratch, s32 f32 [C, 28 V2] and s64 f64
// [C, 20 V2] (32 V2 with the fallback); path 1: the f32 recursion in the
// shared memory of one block (at most 2048 sites, 96 V2 bytes <= 220 KiB),
// no s32, s64 as on path 0; path 2: the f64 set in shared memory too (160 V2
// bytes more), s64 f64 [C, 24 V2] with the fallback and unused without it;
// path 3: `cluster` blocks a chain (2 to 8, a divisor of Nx; a block's
// Nx / cluster rows hold at most 2048 sites and, with two halo rows, 220
// KiB), scratch as on path 1; path 4: the same blocks, not a cluster, in
// one cooperative launch (all C * cluster blocks resident at once, or the
// launch fails), exchanging through xch, uint64 [C, ru_l2_words], which
// must be 0 before the first such launch and is 0 again after each; xch is
// unused on the other paths.
extern "C" int solve_ru_launch(const void* thE, const void* thO, const void* b, const void* hist,
                               int K, void* x, void* x64, void* iters, void* fb_iters, void* conv,
                               void* s32, void* s64, void* clocks, void* xch, int C, int Nx,
                               int Nth,
                               double m0, double tol, double tau, int max_iter, int max_outer,
                               int certify, int cert_k, int fallback, int fb_max_iter,
                               int fb_max_rounds, int path, int cluster, void* stream) {
  if (K < 1 || K > sm::kMreMax) return static_cast<int>(cudaErrorInvalidValue);
  const sm::RuParams p{static_cast<const float*>(thE),
                       static_cast<const float*>(thO),
                       static_cast<const float*>(b),
                       static_cast<const float*>(hist),
                       K,
                       C,
                       static_cast<float*>(x),
                       static_cast<double*>(x64),
                       static_cast<int*>(iters),
                       static_cast<int*>(fb_iters),
                       static_cast<unsigned char*>(conv),
                       static_cast<float*>(s32),
                       static_cast<double*>(s64),
                       static_cast<long long*>(clocks),
                       Nx,
                       Nth,
                       m0,
                       tol,
                       tau,
                       max_iter,
                       max_outer,
                       certify,
                       cert_k,
                       fallback,
                       fb_max_iter,
                       fb_max_rounds,
                       path == 2 ? 1 : 0,
                       static_cast<unsigned long long*>(xch),
                       cluster};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mre = K > 1;  // the kernels with the MRE prologue
  size_t bytes = 0;
  if (!ru_shared_bytes(path, Nx, Nth, cluster, bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    const auto k = mre ? sm::solve_ru_global_kernel<true> : sm::solve_ru_global_kernel<false>;
    k<<<C, sm::kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const void* kernel = ru_kernel(path, mre);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (path == 1 || path == 2) {
    const auto k = mre ? sm::solve_ru_shared_kernel<true> : sm::solve_ru_shared_kernel<false>;
    k<<<C, sm::kThreads, bytes, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  // `cluster` blocks a chain, each with its rows of x and two halo rows in
  // shared memory: a cluster (path 3) or a cooperative launch (path 4)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * cluster);
  cfg.blockDim = dim3(sm::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (path == 3) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<sm::RuParams*>(&p)};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the card runs at once of K3's kernel on `path` for an Nx x 2 Nth
// lattice on n blocks a chain: clusters of n on path 3
// (cudaOccupancyMaxActiveClusters), blocks on the others (the blocks a
// multiprocessor runs by the occupancy calculator, times the
// multiprocessors: on path 4 the most a cooperative launch may hold); or
// minus the CUDA error.
extern "C" int solve_ru_at_once(int Nx, int Nth, int path, int n) {
  size_t bytes = 0;
  if (!ru_shared_bytes(path, Nx, Nth, n, bytes)) return -static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = ru_kernel(path, false);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
  int out = 0;
  if (e == cudaSuccess && path == 3) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n);
    cfg.blockDim = dim3(sm::kThreads);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&out, kernel, &cfg);
  } else if (e == cudaSuccess) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, sm::kThreads, bytes);
    out = per_sm * sms;
  }
  return e == cudaSuccess ? out : -static_cast<int>(e);
}

// The 8-byte words of the L2 path's exchange area a chain on n blocks of
// rows of Nth sites (ru_l2_words): what xch holds a chain.
extern "C" int solve_ru_l2_words(int n, int Nth) {
  return static_cast<int>(sm::ru_l2_words(n, Nth));
}
