// K10: K2's f32 solve on (Dhat Dhat^+) x = b with every x-axis shift of the
// stencil computed on the tensor cores, as a product with a one-hot
// permutation matrix.
//
// Replaces schwingermodel_tpu/tools/bench_mxu_stencil.py:_solve_kernel_variant
// (variant "mxu_xshift"): the experiment that asks whether a stencil gets
// faster when the matrix unit, idle otherwise, moves the data. Everything
// but the x-neighbours is K2 (solve_fused.cu): the links built in-kernel,
// the CG loop with its guards, the outputs x, iterations, rho and ||b||^2,
// and where the fields live (ops/traj.cg_path, K2's rule):
//
// - shared (up to 64x64): K2's CG store (CgShared of shared_stencil.cuh:
//   both parities' links, d, r, t1, t2 in shared memory, x in registers,
//   the sums by BlockSumTree) and K2's loop; only the operator differs. Its
//   four stages run as work items of 8 x-rows (a row tile) by 4 packed
//   t-columns, one warp an item. Per item the x-neighbours of the 32 sites
//   come from f64 m8n8k4 products: XP = P+ S (the source spinor at x+1)
//   and XM = P- W, W = conj(u1)(s0 -+ i s1) at the source (hop_bx), with
//   P+[i][j] = (j == i+1 mod Nx) and P-[i][j] = (j == i-1 mod Nx). The
//   product's 8 columns are ordered [t][plane pair]: column 2 t + p holds
//   plane p of the pair (re, im) at column t0 + t; spin 0's pair and spin
//   1's pair are two tiles, so a lane ends with all four planes of XP and
//   of XM at its site (x = m0 + lane/4, t = t0 + lane%4) in registers, and
//   runs the site pass of K2 (hop_combine, with the t-neighbours gathered
//   from shared memory) there. A: P's entries, built in registers from the
//   lane's indices (1 where k is the row's neighbour, no table); only the
//   k-tiles (4 values of k from a multiple of 4) that hold a nonzero of the
//   row tile run (band_tile: 3 of Nx/4 for each product, the wrap
//   included; the tiles skipped are zero, so the product is the same),
//   walked as one window of 4 tiles so that a source row both products
//   use is read once. B: the source values from the store, widened to
//   f64; W is formed as its fragment is loaded and never stored. The fourth stage
//   writes Dhat t2 back into t2 in place, and after one more barrier
//   (7 an iteration, against K2's 6) the threads of CgShared read it at
//   their own sites for <d, Ad> and the x, r updates: x, iterations and
//   flags are K2's bit for bit;
// - global (a lattice no block holds, e.g. 128x128): the loop of
//   cg_f32_op over a per-chain global scratch (K2's 32 f32 values a site)
//   with the same stages on the planar layout, 11 barriers an iteration.
//
// The product must be exact, or the operator is no longer Dhat Dhat^+. The
// tensor cores take no f32 operands, and a TF32 operand keeps 10 mantissa
// bits. This kernel takes the f64 shape, mma.sync.m8n8k4 on double: a
// plane's f32 values widen to f64 without loss, each product is 1 * a or
// 0 * a, a column of P holds a single 1, so every sum is one value plus
// zeros and rounds back to f32 unchanged: exact by construction, on any
// card, for every finite input (a -0 comes out as +0). Three TF32 parts
// accumulated in f32 would be exact only if the card's accumulator kept
// every bit of hi + mid + lo, which would have to be shown on each card;
// not taken. A non-finite value reaches, through 0 * inf = NaN, every row
// of each row tile whose k-tiles of the product include its row, in its
// own column: 8 or 16 rows around it (the whole column with a dense
// product). The chain's outcome is the same: the next dot carries the NaN
// to every site, and chains are separate blocks.
//
// What bounds it on the card: as K2, the barriers and what a thread waits
// for after each; the products add 2 directions x 2 plane pairs x 3
// k-steps = 12 m8n8k4 an item, 6144 flops for 32 sites, against the card's
// f64 tensor-core peak of 67 TFLOP/s (NVIDIA H100 SXM data sheet).
#include "shared_stencil.cuh"

namespace sm {

// D = A B + C on one 8x8x4 f64 tile: A row-major 8x4, one element a thread
// at (row lane/4, column lane%4); B 4x8 at (row lane%4, column lane/4); C
// and D 8x8, two elements a thread at (row lane/4, columns 2 (lane%4) + 0,1).
__device__ __forceinline__ void dmma(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}

// The band of row tile m0 (rows m0 .. m0+7, m0 a multiple of 8): the
// k-tiles (4 values of k from a multiple of 4, k below Nx rounded up to 4,
// K4) that hold P's nonzeros of the tile's rows. P+ takes the n tiles
// (m0 + 4 i) mod K4 and P- the n tiles (m0 - 4 + 4 i) mod K4, i < n =
// min(3, K4 / 4): the tiles of k = m0+1 .. m0+8 (of m0-1 .. m0+6), the
// wrap tile included (k = 0 for row Nx-1 of P+, k = Nx-1 for row 0 of P-),
// each once; every tile left out is zero on the tile's rows. Walked as the
// window j = 0 .. 3 of tiles (m0 - 4 + 4 j) mod K4: P- on j < n, P+ on
// 1 <= j <= n, so a tile both products use is read once.
__device__ __forceinline__ int band_steps(int Nx) { return min(3, ((Nx + 3) & ~3) >> 2); }
__device__ __forceinline__ int band_tile(int m0, int j, int Nx) {
  const int K4 = (Nx + 3) & ~3;
  const int k0 = m0 - 4 + 4 * j;  // in [-4, K4 + 4)
  return k0 < 0 ? k0 + K4 : (k0 >= K4 ? k0 - K4 : k0);
}

// xp[p][i] += (P+ B+)[m0 + lane/4][column 2 (lane%4) + i] of plane pair p,
// and xm the same for P- B-, over the band of row tile m0. The lane's entry
// of A is P[m0 + lane/4][k0 + lane%4]: 1 where k is its row's neighbour
// (x+1 or x-1 modulo Nx), 0 elsewhere and on the rows beyond Nx.
// load(k, with_m, bp0, bp1, bm0, bm1) gives the lane's B entries at row k
// of its column (t0 + lane/8, plane (lane/4) & 1 of pair 0 and of pair 1),
// zero beyond the lattice: B+ always, B- where with_m.
template <typename LoadB>
__device__ __forceinline__ void banded_products(int m0, int Nx, const LoadB& load,
                                                double (&xp)[2][2], double (&xm)[2][2]) {
  const int lane = threadIdx.x & 31, row = m0 + (lane >> 2), q = lane & 3;
  const int n = band_steps(Nx);
  const bool live = row < Nx;
  const int up = row + 1 == Nx ? 0 : row + 1, down = row == 0 ? Nx - 1 : row - 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool use_m = j < n, use_p = j >= 1 && j <= n;  // the same in every lane
    if (!use_m && !use_p) continue;
    const int k = band_tile(m0, j, Nx) + q;
    double bp0, bp1, bm0, bm1;
    load(k, use_m, bp0, bp1, bm0, bm1);
    if (use_m) {
      const double a = live && k == down ? 1.0 : 0.0;
      dmma(xm[0][0], xm[0][1], a, bm0);
      dmma(xm[1][0], xm[1][1], a, bm1);
    }
    if (use_p) {
      const double a = live && k == up ? 1.0 : 0.0;
      dmma(xp[0][0], xp[0][1], a, bp0);
      dmma(xp[1][0], xp[1][1], a, bp1);
    }
  }
}

// A spinor's two spins and a link at site s on either layout: the CG
// store's site-major one (float4 a spinor site, float2 a link) or the
// planar one of stencil.cuh (the global path).
__device__ __forceinline__ void spins(const float4* S, int s, int, Cx<float>& s0,
                                      Cx<float>& s1) {
  const float4 v = S[s];
  s0 = lo(v);
  s1 = hi(v);
}
__device__ __forceinline__ void spins(const float* S, int s, int V2, Cx<float>& s0,
                                      Cx<float>& s1) {
  s0 = ld(S, 0, s, V2);
  s1 = ld(S, 1, s, V2);
}
__device__ __forceinline__ Cx<float> link(const float2* U, int mu, int s, int V2) {
  return cx(U[mu * V2 + s]);
}
__device__ __forceinline__ Cx<float> link(const float* U, int mu, int s, int V2) {
  return ld(U, mu, s, V2);
}
__device__ __forceinline__ void put(float4* out, int s, int, Cx<float> h0, Cx<float> h1) {
  out[s] = f4(h0, h1);
}
__device__ __forceinline__ void put(float* out, int s, int V2, Cx<float> h0, Cx<float> h1) {
  st(out, 0, s, V2, h0);
  st(out, 1, s, V2, h1);
}

// out = hop(S) at every target site, or a*v + b*hop(S) (v may be out: each
// lane reads v and writes out at its own site only), with the x-neighbours
// from the banded products. Work items (row tile, group of 4 packed
// columns), one warp each; the caller puts barriers around it.
template <bool DAG, bool AXPBY, typename L, typename S>
__device__ void stage_mxu(const L* Ut, const L* Us, const S* Sp, int tgt_parity, S* out,
                          const S* v, float a, float bb, const Geo& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tg = (g.Nth + 3) / 4, items = (g.Nx + 7) / 8 * tg;
  const int bt = lane >> 3, bp = (lane >> 2) & 1;  // the lane's B column: t, plane
  for (int item = warp; item < items; item += kThreads / 32) {
    const int m0 = 8 * (item / tg), t0 = 4 * (item % tg);
    const int tb = min(t0 + bt, g.Nth - 1);
    const bool col_ok = t0 + bt < g.Nth;
    double xp[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, xm[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    // B+ = S and B- = W = hop_bx(u1, S) at the source, from one read of S;
    // rows and columns beyond the lattice read an edge site and give 0
    banded_products(m0, g.Nx, [&](int k, bool with_m, double& bp0, double& bp1, double& bm0,
                                  double& bm1) {
      const bool ok = col_ok && k < g.Nx;
      const int src = min(k, g.Nx - 1) * g.Nth + tb;
      Cx<float> s0, s1;
      spins(Sp, src, g.V2, s0, s1);
      bp0 = ok ? (bp ? s0.im : s0.re) : 0.0f;
      bp1 = ok ? (bp ? s1.im : s1.re) : 0.0f;
      if (with_m) {
        Cx<float> w0, w1;
        hop_bx<float, DAG>(link(Us, 1, src, g.V2), s0, s1, w0, w1);
        bm0 = ok ? (bp ? w0.im : w0.re) : 0.0f;
        bm1 = ok ? (bp ? w1.im : w1.re) : 0.0f;
      }
    }, xp, xm);
    // the site pass at this lane's site, K2's hop_combine
    const int x = m0 + (lane >> 2), t = t0 + (lane & 3);
    if (x < g.Nx && t < g.Nth) {
      const int s = x * g.Nth + t;
      const Nbr n = neighbours(x, t, (x + tgt_parity) & 1, g);
      Cx<float> p0t, p1t, s0t, s1t, h0, h1;
      spins(Sp, n.pt, g.V2, p0t, p1t);
      spins(Sp, n.mt, g.V2, s0t, s1t);
      const Cx<float> p0x{static_cast<float>(xp[0][0]), static_cast<float>(xp[0][1])};
      const Cx<float> p1x{static_cast<float>(xp[1][0]), static_cast<float>(xp[1][1])};
      const Cx<float> bx0{static_cast<float>(xm[0][0]), static_cast<float>(xm[0][1])};
      const Cx<float> bx1{static_cast<float>(xm[1][0]), static_cast<float>(xm[1][1])};
      hop_combine<float, DAG>(link(Ut, 0, s, g.V2), link(Ut, 1, s, g.V2), p0t, p1t, p0x, p1x,
                              link(Us, 0, n.mt, g.V2), s0t, s1t, bx0, bx1, h0, h1);
      if (AXPBY) {
        Cx<float> v0, v1;
        spins(v, s, g.V2, v0, v1);
        h0 = axpby(a, v0, bb, h0);
        h1 = axpby(a, v1, bb, h1);
      }
      put(out, s, g.V2, h0, h1);
    }
  }
}

// The shared path's operator for CgShared::solve: Ad = (Dhat Dhat^+) d into
// a (and t2) at the thread's own sites, <d, Ad> returned; the first barrier
// makes the d written just before visible.
struct MxuApply {
  CgShared* S;
  __device__ __forceinline__ float operator()(float (&a)[kOwnSites][4]) const {
    CgShared& C = *S;
    const Geo& g = C.g;
    __syncthreads();
    stage_mxu<true, false>(C.uo, C.ue, C.d, 1, C.t1, C.d, 0.f, 0.f, g);  // (H_eo)^+ d
    __syncthreads();
    stage_mxu<true, true>(C.ue, C.uo, C.t1, 0, C.t2, C.d, C.m, -C.c, g);  // Dhat^+ d
    __syncthreads();
    stage_mxu<false, false>(C.uo, C.ue, C.t2, 1, C.t1, C.t2, 0.f, 0.f, g);  // H_oe t2
    __syncthreads();
    stage_mxu<false, true>(C.ue, C.uo, C.t1, 0, C.t2, C.t2, C.m, -C.c, g);  // Dhat t2
    __syncthreads();
    float dv[kOwnSites][4];
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (C.mine(j)) {
        const float4 as = C.t2[s], ds = C.d[s];
        a[j][0] = as.x, a[j][1] = as.y, a[j][2] = as.z, a[j][3] = as.w;
        dv[j][0] = ds.x, dv[j][1] = ds.y, dv[j][2] = ds.z, dv[j][3] = ds.w;
      }
    }
    return C.dot(dv, a);
  }
};

__global__ void __launch_bounds__(kThreads)
solve_mxu_shared_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                        const float* __restrict__ b_all, const float* __restrict__ x0_all,
                        float* __restrict__ x_all, int* __restrict__ iters_out,
                        float* __restrict__ rho_out, float* __restrict__ bnorm_out, int Nx,
                        int Nth, float m, float c, double tol, int max_iter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double sh[2 * (kThreads / 32)];
  const Geo g{Nx, Nth, Nx * Nth};
  const size_t ch = blockIdx.x;
  CgShared S = cg_shared(smem, sh, g, m, c);
  make_links_shared(thE + ch * 2 * g.V2, 0, S.ue, g);
  make_links_shared(thO + ch * 2 * g.V2, 1, S.uo, g);
  const CgOut o = S.solve(MxuApply{&S}, b_all + ch * 4 * g.V2, x0_all + ch * 4 * g.V2, tol,
                          max_iter);
  S.write_x(x_all + ch * 4 * g.V2);
  if (threadIdx.x == 0) {
    iters_out[ch] = o.iters;
    rho_out[ch] = o.rho;
    bnorm_out[ch] = o.bnorm2;
  }
}

// out = (Dhat Dhat^+) v on the planar layout, as cg_f32_op takes its
// operator: starts and ends with a barrier.
struct MxuPlanarOp {
  const float *ue, *uo;
  float *t1, *t2, *t3;
  float m, c;
  Geo g;
  __device__ __forceinline__ void operator()(const float* v, float* out) const {
    __syncthreads();
    stage_mxu<true, false>(uo, ue, v, 1, t1, v, 0.f, 0.f, g);
    __syncthreads();
    stage_mxu<true, true>(ue, uo, t1, 0, t2, v, m, -c, g);
    __syncthreads();
    stage_mxu<false, false>(uo, ue, t2, 1, t3, t2, 0.f, 0.f, g);
    __syncthreads();
    stage_mxu<false, true>(ue, uo, t3, 0, out, t2, m, -c, g);
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kThreads)
solve_mxu_global_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                        const float* __restrict__ b_all, const float* __restrict__ x0_all,
                        float* __restrict__ x_all, int* __restrict__ iters_out,
                        float* __restrict__ rho_out, float* __restrict__ bnorm_out,
                        float* __restrict__ scratch, int Nx, int Nth, float m, float c,
                        double tol, int max_iter) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int ch = blockIdx.x;
  float* sc = scratch + (size_t)ch * 32 * V2;
  float *ue = sc, *uo = sc + 4 * V2;
  make_links<float>(thE + (size_t)ch * 2 * V2, 0, ue, g);
  make_links<float>(thO + (size_t)ch * 2 * V2, 1, uo, g);
  const MxuPlanarOp op{ue, uo, sc + 20 * V2, sc + 24 * V2, sc + 28 * V2, m, c, g};
  const CgOut o = cg_f32_op(op, b_all + (size_t)ch * 4 * V2, x0_all + (size_t)ch * 4 * V2,
                            x_all + (size_t)ch * 4 * V2, sc + 8 * V2, sc + 12 * V2,
                            sc + 16 * V2, tol, max_iter, g, sh);
  if (threadIdx.x == 0) {
    iters_out[ch] = o.iters;
    rho_out[ch] = o.rho;
    bnorm_out[ch] = o.bnorm2;
  }
}

// The shifts alone: out_p = P+ in and out_m = P- in for n_planes planes
// [Nx][Nth], by the fragments of the stages (banded_products, the columns
// [t][plane pair]), one block per four planes taken as the two pairs of a
// spinor. The proof that the product is exact is made on this entry.
__global__ void __launch_bounds__(kThreads)
shift_mxu_kernel(const float* __restrict__ in, float* __restrict__ out_p,
                 float* __restrict__ out_m, int n_planes, int Nx, int Nth) {
  const Geo g{Nx, Nth, Nx * Nth};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane0 = 4 * blockIdx.x;
  const int tg = (Nth + 3) / 4, items = (Nx + 7) / 8 * tg;
  const int bt = lane >> 3, bp = (lane >> 2) & 1;
  for (int item = warp; item < items; item += kThreads / 32) {
    const int m0 = 8 * (item / tg), t0 = 4 * (item % tg);
    const int tb = t0 + bt;
    double xp[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, xm[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    banded_products(m0, Nx, [&](int k, bool, double& bp0, double& bp1, double& bm0,
                                double& bm1) {
      const int p0 = plane0 + bp, p1 = plane0 + 2 + bp;
      const bool ok = k < Nx && tb < Nth;
      const size_t s = static_cast<size_t>(k) * Nth + tb;
      bp0 = bm0 = ok && p0 < n_planes ? static_cast<double>(in[p0 * static_cast<size_t>(g.V2) + s]) : 0.0;
      bp1 = bm1 = ok && p1 < n_planes ? static_cast<double>(in[p1 * static_cast<size_t>(g.V2) + s]) : 0.0;
    }, xp, xm);
    const int x = m0 + (lane >> 2), t = t0 + (lane & 3);
    for (int pr = 0; pr < 2; ++pr)
      for (int i = 0; i < 2; ++i) {
        const int pl = plane0 + 2 * pr + i;
        if (x < Nx && t < Nth && pl < n_planes) {
          const size_t o = pl * static_cast<size_t>(g.V2) + static_cast<size_t>(x) * Nth + t;
          out_p[o] = static_cast<float>(xp[pr][i]);
          out_m[o] = static_cast<float>(xm[pr][i]);
        }
      }
  }
}

}  // namespace sm

// path 0: the global scratch, f32 [C, 32 V2]; path 1: K2's shared store (at
// most 2048 sites, 96 V2 bytes), no scratch.
extern "C" int solve_mxu_launch(const void* thE, const void* thO, const void* b, const void* x0,
                                void* x, void* iters, void* rho, void* bnorm, void* scratch,
                                int C, int Nx, int Nth, double m0, double tol, int max_iter,
                                int path, void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *th_e = static_cast<const float*>(thE), *th_o = static_cast<const float*>(thO);
  const float *bb = static_cast<const float*>(b), *xx0 = static_cast<const float*>(x0);
  if (path == 0) {
    sm::solve_mxu_global_kernel<<<C, sm::kThreads, 0, s>>>(
        th_e, th_o, bb, xx0, static_cast<float*>(x), static_cast<int*>(iters),
        static_cast<float*>(rho), static_cast<float*>(bnorm), static_cast<float*>(scratch), Nx,
        Nth, m, c, tol, max_iter);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t V2 = static_cast<size_t>(Nx) * Nth;
  const size_t bytes = sm::kCgSharedBytes * V2;
  if (path != 1 || V2 > sm::kOwnSites * sm::kThreads || bytes > sm::kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      sm::solve_mxu_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  sm::solve_mxu_shared_kernel<<<C, sm::kThreads, bytes, s>>>(
      th_e, th_o, bb, xx0, static_cast<float*>(x), static_cast<int*>(iters),
      static_cast<float*>(rho), static_cast<float*>(bnorm), Nx, Nth, m, c, tol, max_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shift_mxu_launch(const void* in, void* out_p, void* out_m, int n_planes, int Nx,
                                int Nth, void* stream) {
  sm::shift_mxu_kernel<<<(n_planes + 3) / 4, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out_p), static_cast<float*>(out_m),
      n_planes, Nx, Nth);
  return static_cast<int>(cudaGetLastError());
}
