// K9: the f64 true residual r = b - (Dhat Dhat^+) x of the restart
// refinement, and each entry's ||r||^2.
//
// Replaces schwingermodel_tpu/ops/pallas_df.py:_df_residual_kernel
// (df_residual_fused): the TPU kernel evaluates the links and the apply in
// double-float from the f32 angles; the card has native f64, so the links
// are sincos((double)theta) (make_links<double>, the antiperiodic sign
// folded in) and the apply is the f64 stencil of stencil.cuh. Inputs per
// entry (configuration c, right-hand side j; entry e = c * B + j): the angle
// planes of c, b in f32 and x in f64; outputs r in f64 and its f64
// ||r||^2, which the refinement's stop and stagnation tests read next
// (solvers/refine.py, through ops/refined.residual_f64).
//
// What bounds it on the card: its bytes, 80 a half-lattice site and entry
// (b, x, r) and 16 a site and configuration (the angles): 43 MB at 64x64
// C=32 B=8, 12.8 us at 3.35 TB/s; its f64 flops (~290 a site and entry)
// take a third of that. Where its fields live is chosen by the lattice size
// and the counts before the launch (ops/refined.residual_path):
//
// - shared (every lattice a split of at most 8 holds, 128x128 included):
//   one block holds a slab of rows of one configuration in shared memory,
//   its f64 links of both parities (two double2 a site and parity) and two
//   f64 spinor planes (spin 0 and spin 1 one double2 a site each): 128 bytes
//   a site. The links are built once a block and serve `rhs` right-hand
//   sides of the configuration in turn; each is loaded (x at the thread's
//   own sites kept in registers), and the four stages of the apply run on
//   the slab, each stage by the per-site f64 expressions of the global
//   route (hop_bx, hop_combine, axpby), so r has its bits: v, then
//   (H_eo)^+ v into the second plane, Dhat^+ v into the first (v's own
//   values come from registers, and its own Dhat^+ v stays there), H_oe of
//   it into the second, and Dhat of it at the slab's own rows, where
//   r = b - out is written and squared. A lattice one block cannot hold
//   is split into 2-8 slabs of Nx / n rows, each with kHaloW rows of its
//   neighbours on either side, which wrap modulo Nx and are computed again
//   (K1's no-solve rule, force_shared.cuh): each hop spoils one row at
//   either edge, so the four leave the slab's own rows exact, and a slab
//   whose first row is odd flips the checkerboard's t-offset of all its
//   rows. Four barriers a right-hand side. ||r||^2: each thread adds its
//   squares, the warps' sums go to one slot a right-hand side, and after
//   one barrier each is added in block_sum's order of warps
//   (warp_partials_sum); with n > 1 each block writes its f64 partial, and
//   the configuration's last block to finish (a ticket a block group,
//   zeroed by the launch) adds the n partials in rank order, as K7 does
//   (halo_normal.cu);
// - global (a lattice no split holds): one block of
//   512 threads an entry over a global scratch of 20 f64 values a site
//   (links and three stencil temporaries), normal_apply<double> and
//   block_sum.
//
// With a mask `active` (bool [C, B], or null for every entry) an inactive
// entry is left as it was: r and ||r||^2 are not written and its x is not
// read, so the caller passes the previous pass's r and ||r||^2 as the
// outputs (solvers/refine.py), and a block whose entries are all inactive
// returns before building its links.
//
// Both routes give r with the same bits; ||r||^2 differs between them only
// in the order of its f64 adds, and two launches of one route on the same
// inputs give the same bits (no atomics on the values: the ticket picks
// which block adds, not the order).
#include "shared_stencil.cuh"

namespace sm {

constexpr int kResidualScratch = 20;       // f64 values a site and entry, global route
constexpr int kResidualSharedBytes = 128;  // shared route: links 64, two spinor planes 64
constexpr int kResidualMaxRhs = 8;         // right-hand sides a block of the shared route

__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                const float* __restrict__ b_all, const double* __restrict__ x_all,
                double* __restrict__ r_all, double* __restrict__ rnorm_out,
                double* __restrict__ scratch, const bool* __restrict__ active, int B, int Nx,
                int Nth, double m, double c) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2, n = 4 * V2;
  const int e = blockIdx.x;
  const int cfg = e / B;
  if (active != nullptr && !active[e]) return;
  double* s = scratch + (size_t)e * kResidualScratch * V2;
  double *ue = s, *uo = s + 4 * V2, *t1 = s + 8 * V2, *t2 = s + 12 * V2, *t3 = s + 16 * V2;
  make_links<double>(thE + (size_t)cfg * 2 * V2, 0, ue, g);
  make_links<double>(thO + (size_t)cfg * 2 * V2, 1, uo, g);
  const float* b = b_all + (size_t)e * n;
  double* r = r_all + (size_t)e * n;
  normal_apply<double>(ue, uo, x_all + (size_t)e * n, r, t1, t2, t3, m, c, g);
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double ri = static_cast<double>(b[i]) - r[i];
    r[i] = ri;
    acc += ri * ri;
  }
  const double rn = block_sum(acc, sh);
  if (threadIdx.x == 0) rnorm_out[e] = rn;
}

__device__ __forceinline__ Cx<double> cx(double2 v) { return {v.x, v.y}; }
__device__ __forceinline__ double2 d2(Cx<double> a) { return make_double2(a.re, a.im); }

// hop_site<double> on the shared layout of the shared route: links u0 at
// [s] and u1 at [V + s], spinors spin 0 at [s] and spin 1 at [V + s]; the
// operands and the order of hop_site.
template <bool DAG>
__device__ __forceinline__ void hop_site_f64(const double2* Ut, const double2* Us,
                                             const double2* S, int s, const Nbr& n, int V,
                                             Cx<double>& h0, Cx<double>& h1) {
  Cx<double> bx0, bx1;
  hop_bx<double, DAG>(cx(Us[V + n.mx]), cx(S[n.mx]), cx(S[V + n.mx]), bx0, bx1);
  hop_combine<double, DAG>(cx(Ut[s]), cx(Ut[V + s]), cx(S[n.pt]), cx(S[V + n.pt]),
                           cx(S[n.px]), cx(S[V + n.px]), cx(Us[n.mt]), cx(S[n.mt]),
                           cx(S[V + n.mt]), bx0, bx1, h0, h1);
}

// The shared route: block (unit, rank) with unit = c * (B / rhs) + group
// holds slab `rank` of configuration c's `blocks` slabs and runs the rhs
// right-hand sides group * rhs .. of c through it.
__global__ void __launch_bounds__(kThreads)
residual_shared_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                       const float* __restrict__ b_all, const double* __restrict__ x_all,
                       double* __restrict__ r_all, double* __restrict__ rnorm_out,
                       double* __restrict__ parts, unsigned* __restrict__ tickets,
                       const bool* __restrict__ active, int B, int Nx, int Nth, double m,
                       double c, int blocks, int rhs) {
  extern __shared__ __align__(16) double2 smem2[];
  __shared__ double warp_sums[kResidualMaxRhs * (kThreads / 32)];
  __shared__ bool last;
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int unit = blockIdx.x / blocks, rank = blockIdx.x - unit * blocks;
  const int groups = B / rhs, cfg = unit / groups;
  const size_t e0 = static_cast<size_t>(cfg) * B + (unit - cfg * groups) * rhs;
  // every block of a unit reads the same flags, so a unit with no active
  // entry takes no ticket
  bool any = active == nullptr;
  for (int q = 0; q < rhs && !any; ++q) any = active[e0 + q];
  if (!any) return;
  // the slab: global rows [first, first + rows + 2 halo), modulo Nx
  const int halo = blocks > 1 ? kHaloW : 0;
  const int rows = Nx / blocks, first = rank * rows - halo;
  const Geo lg{rows + 2 * halo, Nth, (rows + 2 * halo) * Nth};
  const int V = lg.V2, par = first & 1;
  double2* ue = smem2;
  double2* uo = ue + 2 * V;
  double2* P = uo + 2 * V;  // v, then Dhat^+ v
  double2* Q = P + 2 * V;   // (H_eo)^+ v, then H_oe Dhat^+ v
  make_links_rows(thE + static_cast<size_t>(cfg) * 2 * V2, 0, ue, lg, first, g);
  make_links_rows(thO + static_cast<size_t>(cfg) * 2 * V2, 1, uo, lg, first, g);
  OwnSites own;
  own.init(lg);
  int gs[kOwnSites];  // the global site of each own site
#pragma unroll
  for (int j = 0; j < kOwnSites; ++j) {
    const int xl = own.sxk[j] >> 16;
    gs[j] = ((first + xl) % Nx + Nx) % Nx * Nth + (own.sxk[j] & 0xffff);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int q = 0; q < rhs; ++q) {
    const size_t e = e0 + q;
    if (active != nullptr && !active[e]) continue;  // the same for the whole block
    const double* x = x_all + e * 4 * V2;
    // v at the own sites, in registers, then Dhat^+ v there
    Cx<double> w[kOwnSites][2];
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      if (s < V) {
        w[j][0] = {x[gs[j]], x[V2 + gs[j]]};
        w[j][1] = {x[2 * V2 + gs[j]], x[3 * V2 + gs[j]]};
        P[s] = d2(w[j][0]);
        P[V + s] = d2(w[j][1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {  // (H_eo)^+ v at the odd sites
      const int s = threadIdx.x + j * kThreads;
      if (s < V) {
        Cx<double> h0, h1;
        hop_site_f64<true>(uo, ue, P, s, own.nbrs(j, 1 ^ par, lg), V, h0, h1);
        Q[s] = d2(h0);
        Q[V + s] = d2(h1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {  // Dhat^+ v at the even sites
      const int s = threadIdx.x + j * kThreads;
      if (s < V) {
        Cx<double> h0, h1;
        hop_site_f64<true>(ue, uo, Q, s, own.nbrs(j, par, lg), V, h0, h1);
        w[j][0] = axpby(m, w[j][0], -c, h0);
        w[j][1] = axpby(m, w[j][1], -c, h1);
        P[s] = d2(w[j][0]);
        P[V + s] = d2(w[j][1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {  // H_oe Dhat^+ v at the odd sites
      const int s = threadIdx.x + j * kThreads;
      if (s < V) {
        Cx<double> h0, h1;
        hop_site_f64<false>(uo, ue, P, s, own.nbrs(j, 1 ^ par, lg), V, h0, h1);
        Q[s] = d2(h0);
        Q[V + s] = d2(h1);
      }
    }
    __syncthreads();
    // Dhat Dhat^+ v at the even sites of the slab's own rows; r = b - it
    const float* b = b_all + e * 4 * V2;
    double* r = r_all + e * 4 * V2;
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kOwnSites; ++j) {
      const int s = threadIdx.x + j * kThreads;
      const int xl = own.sxk[j] >> 16;
      if (s < V && xl >= halo && xl < halo + rows) {
        Cx<double> h0, h1;
        hop_site_f64<false>(ue, uo, Q, s, own.nbrs(j, par, lg), V, h0, h1);
        h0 = axpby(m, w[j][0], -c, h0);
        h1 = axpby(m, w[j][1], -c, h1);
        const double o[4] = {h0.re, h0.im, h1.re, h1.im};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const double ri = static_cast<double>(b[p * V2 + gs[j]]) - o[p];
          r[p * V2 + gs[j]] = ri;
          acc += ri * ri;
        }
      }
    }
    // the next right-hand side writes only P before its first barrier,
    // which no thread reads after the third
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) warp_sums[q * (kThreads / 32) + warp] = acc;
  }
  __syncthreads();
  const bool mine = threadIdx.x < rhs && (active == nullptr || active[e0 + threadIdx.x]);
  if (mine) {
    const double tot = warp_partials_sum(warp_sums + threadIdx.x * (kThreads / 32));
    if (blocks == 1) {
      rnorm_out[e0 + threadIdx.x] = tot;
    } else {
      parts[(e0 + threadIdx.x) * blocks + rank] = tot;
      __threadfence();
    }
  }
  if (blocks == 1) return;
  // the group's last block to finish adds its entries' partials in rank
  // order
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + unit, 1u) == static_cast<unsigned>(blocks - 1);
  __syncthreads();
  if (!last) return;
  if (mine) {
    __threadfence();
    const double* part = parts + (e0 + threadIdx.x) * blocks;
    double sum = __ldcg(part);
    for (int k = 1; k < blocks; ++k) sum += __ldcg(part + k);
    rnorm_out[e0 + threadIdx.x] = sum;
  }
}

}  // namespace sm

// thE, thO: f32 [C, 2, Nx, Nth]; b: f32 and x, r: f64 [C, B, 2, 2, Nx, Nth];
// rnorm: f64 [C, B]. path 0: the global scratch, f64 [C * B, 20 * Nx * Nth];
// path 1: shared memory, `blocks` slabs a configuration (1, or a divisor of
// an even Nx whose rows, with 4 rows on either side, hold at most 2048
// sites and 220 KB at 128 bytes a site) and `rhs` right-hand sides a block
// (1 to 8, dividing B); with blocks > 1 the scratch is f64 [C * B * blocks]
// for the slabs' partials and tickets uint32 [C * B / rhs], zeroed here on
// the stream before the kernel, else both null. active: bool [C, B], or null
// for every entry.
extern "C" int residual_launch(const void* thE, const void* thO, const void* b, const void* x,
                               void* r, void* rnorm, void* scratch, void* tickets, int C, int B,
                               int Nx, int Nth, double m0, const void* active, int path,
                               int blocks, int rhs, void* stream) {
  const double m = m0 + 2.0, c = 1.0 / (4.0 * (m0 + 2.0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *th_e = static_cast<const float*>(thE), *th_o = static_cast<const float*>(thO);
  const float* bb = static_cast<const float*>(b);
  const double* xx = static_cast<const double*>(x);
  const bool* act = static_cast<const bool*>(active);
  if (path == 0) {
    sm::residual_kernel<<<C * B, sm::kThreads, 0, st>>>(
        th_e, th_o, bb, xx, static_cast<double*>(r), static_cast<double*>(rnorm),
        static_cast<double*>(scratch), act, B, Nx, Nth, m, c);
    return static_cast<int>(cudaGetLastError());
  }
  const int rows = blocks > 0 ? Nx / blocks : 0;
  const size_t sites = static_cast<size_t>(rows + (blocks > 1 ? 2 * sm::kHaloW : 0)) * Nth;
  const size_t bytes = sm::kResidualSharedBytes * sites;
  if (path != 1 || blocks < 1 || Nx % blocks != 0 || (blocks > 1 && Nx % 2 != 0) ||
      rhs < 1 || rhs > sm::kResidualMaxRhs || B % rhs != 0 ||
      sites > sm::kOwnSites * sm::kThreads || bytes > sm::kSharedMax ||
      (blocks > 1 && (scratch == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      sm::residual_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm::kSharedMax);
  if (e == cudaSuccess && blocks > 1)
    e = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * C * (B / rhs), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  sm::residual_shared_kernel<<<C * (B / rhs) * blocks, sm::kThreads, bytes, st>>>(
      th_e, th_o, bb, xx, static_cast<double*>(r), static_cast<double*>(rnorm),
      static_cast<double*>(scratch), static_cast<unsigned*>(tickets), act, B, Nx, Nth, m, c,
      blocks, rhs);
  return static_cast<int>(cudaGetLastError());
}
