// K10: K2's f32 solve on (Dhat Dhat^+) x = b with every x-axis shift of the
// stencil computed on the tensor cores, as a product with a one-hot
// permutation matrix.
//
// Replaces schwingermodel_tpu/tools/bench_mxu_stencil.py:_solve_kernel_variant
// (variant "mxu_xshift"): the experiment that asks whether a stencil gets
// faster when the matrix unit, idle otherwise, moves the data. Everything
// but the x-shifts is K2 (solve_fused.cu): the links built in-kernel, the
// CG loop of stencil.cuh (cg_f32_op) per chain with its guards, the outputs
// x, iterations, rho and ||b||^2. A hop becomes three passes:
//
//   1. at every source site, the x-backward products conj(u1s)(s0 -+ i s1)
//      (hop_bx, the arithmetic K2 does in place) are written to 4 planes W;
//   2. XP = P+ S (the source spinor's 4 real planes at x+1) and XM = P- W
//      (the products at x-1), with P+[i][j] = (j == i+1 mod Nx) and
//      P-[i][j] = (j == i-1 mod Nx), by mma.sync in this kernel's body;
//   3. the site pass (hop_combine, shared with K2) reads XP and XM at its
//      own site where K2 reads S and the products at x+1 and x-1; the t
//      neighbours are gathered by index as in K2.
//
// The product must be exact, or the operator is no longer Dhat Dhat^+. The
// tensor cores take no f32 operands, and a TF32 operand keeps 10 mantissa
// bits. Of the two exact ways, this kernel takes the f64 shape,
// mma.sync.m8n8k4 on double: a plane's f32 values widen to f64 without
// loss, each product is 1 * a or 0 * a, a column of P holds a single 1, so
// every sum is one value plus zeros and rounds back to f32 unchanged: exact
// by construction, on any card, for every finite input (a -0 comes out as
// +0). The other way, three TF32 parts accumulated in f32, is exact only if
// the card's accumulator keeps every bit of hi + mid + lo, which would have
// to be shown on each card; it would run at the TF32 rate, 7.4 times the
// f64 rate, and is left to the kernel's redesign. A non-finite value
// spreads to its whole column (0 * inf = NaN), as in a matrix product
// anywhere; chains are separate blocks, so it stays in its chain.
//
// Execution: one thread block per chain, as K2. P+ and P- are built once
// per block in shared memory as f64 one-hot matrices [Nx8][Nx8 + 4] (Nx8 =
// Nx rounded up to 8, rows and columns beyond Nx zero; the row stride is
// padded so that the lanes of an A-fragment load hit distinct banks; 70 KB
// at Nx = 64, and a lattice of Nx above 112 does not fit and is refused;
// kept as f32 and widened per step they cost 128 conversions a warp and
// shift, and the solve 117 against 86 us per iteration on an NVIDIA H100
// 80GB HBM3 at 700 W). Each of
// the block's 16 warps takes one 8-column tile of the 4 planes of a shift
// (laid side by side as [Nx, 4 Nth]: 16 column tiles at 64x64) with 8 row
// tiles, and runs Nx8/4 m8n8k4 steps on the 8 accumulators, which share
// each step's B fragment; that fragment is read from the chain's scratch in
// global memory (L2), once per block, and widened in registers; the A
// fragments come from shared memory.
//
// What bounds it on the card: as K2, barriers and L2 latency, now with
// three barriers more per hop, and the products' 2 Nx Nx Nth flops per
// shifted plane (32 planes per normal apply) against the card's f64
// tensor-core peak of 67 TFLOP/s (NVIDIA H100 SXM data sheet).
#include "stencil.cuh"

namespace sm {

// Row stride of a one-hot matrix in shared memory, for Nx8 rows.
__host__ __device__ inline int perm_stride(int Nx8) { return Nx8 + 4; }

// P+ (delta = +1: b[x] = a[x+1]) or P- (delta = -1) into shared memory.
__device__ void make_perm(double* __restrict__ P, int Nx, int Nx8, int delta) {
  const int ld = perm_stride(Nx8);
  for (int e = threadIdx.x; e < Nx8 * ld; e += blockDim.x) {
    const int i = e / ld, j = e - i * ld;
    const int src = (i + delta + Nx) % Nx;
    P[e] = (i < Nx && j == src) ? 1.0 : 0.0;
  }
}

// D = A B + C on one 8x8x4 f64 tile: A row-major 8x4, one element a thread
// at (row lane/4, column lane%4); B 4x8 at (row lane%4, column lane/4); C
// and D 8x8, two elements a thread at (row lane/4, columns 2 (lane%4) + 0,1).
__device__ __forceinline__ void dmma(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}

// Row tiles one warp accumulates side by side for its column tile: they
// share the B fragment of each step, so a value of `in` is read from L2 by
// one warp only, and their independent accumulator chains hide the latency
// of the f64 mma.
constexpr int kRowTiles = 8;

// out[p] = P in[p] for n_planes planes [Nx][Nth] of f32 values, on the
// tensor cores. The planes lie side by side as the columns of one product:
// n_planes * ceil(Nth / 8) column tiles, each taken by one warp together
// with kRowTiles row tiles. The caller separates it from the writers of
// `in` and the readers of `out` by barriers. Every warp of the block takes
// part.
__device__ void shift_planes(const double* __restrict__ P, const float* __restrict__ in,
                             float* __restrict__ out, int n_planes, int Nx8, const Geo& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int ld = perm_stride(Nx8);
  const int mt = Nx8 / 8, nt = (g.Nth + 7) / 8;
  const int n_tiles = n_planes * nt;
  const int m_chunks = (mt + kRowTiles - 1) / kRowTiles;
  const int grp = lane >> 2, tig = lane & 3;
  for (int item = warp; item < n_tiles * m_chunks; item += n_warps) {
    const int t = item % n_tiles;
    const int m_base = 8 * kRowTiles * (item / n_tiles);
    const int plane = t / nt, n0 = 8 * (t % nt);
    const float* src = in + (size_t)plane * g.V2 + n0 + grp;  // this lane's B column
    const bool col_ok = n0 + grp < g.Nth;
    const double* a_col = P + (m_base + grp) * ld + tig;
    double c0[kRowTiles], c1[kRowTiles];
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) c0[j] = c1[j] = 0.0;
    for (int k0 = 0; k0 < Nx8; k0 += 4) {
      const int row_b = k0 + tig;
      const double b =
          (col_ok && row_b < g.Nx) ? static_cast<double>(src[row_b * g.Nth]) : 0.0;
#pragma unroll
      for (int j = 0; j < kRowTiles; ++j) {
        if (m_base + 8 * j < Nx8)  // the same in every lane of the warp
          dmma(c0[j], c1[j], a_col[8 * j * ld + k0], b);
      }
    }
    const int col = n0 + 2 * tig;
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      const int row = m_base + 8 * j + grp;
      if (row < g.Nx) {
        float* dst = out + (size_t)plane * g.V2 + row * g.Nth;
        if (col < g.Nth) dst[col] = static_cast<float>(c0[j]);
        if (col + 1 < g.Nth) dst[col + 1] = static_cast<float>(c1[j]);
      }
    }
  }
}

// out = hop(S) at every target site, or a*v + b*hop(S), with the x
// neighbours from the tensor-core shifts. W, XP, XM: scratch spinors.
// Starts after a barrier (S complete) and ends with one.
template <bool DAG>
__device__ void hop_stage_mxu(const float* __restrict__ Ut, const float* __restrict__ Us,
                              const float* __restrict__ S, int tgt_parity,
                              float* __restrict__ out, const float* __restrict__ v, float a,
                              float b, float* __restrict__ W, float* __restrict__ XP,
                              float* __restrict__ XM, const double* __restrict__ Pp,
                              const double* __restrict__ Pm, int Nx8, const Geo& g) {
  const int V2 = g.V2;
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    Cx<float> bx0, bx1;
    hop_bx<float, DAG>(ld(Us, 1, s, V2), ld(S, 0, s, V2), ld(S, 1, s, V2), bx0, bx1);
    st(W, 0, s, V2, bx0);
    st(W, 1, s, V2, bx1);
  }
  __syncthreads();
  shift_planes(Pp, S, XP, 4, Nx8, g);
  shift_planes(Pm, W, XM, 4, Nx8, g);
  __syncthreads();
  for (int s = threadIdx.x; s < V2; s += blockDim.x) {
    const int x = s / g.Nth;
    const int k = s - x * g.Nth;
    const Nbr n = neighbours(x, k, (x + tgt_parity) & 1, g);
    Cx<float> h0, h1;
    hop_combine<float, DAG>(ld(Ut, 0, s, V2), ld(Ut, 1, s, V2), ld(S, 0, n.pt, V2),
                            ld(S, 1, n.pt, V2), ld(XP, 0, s, V2), ld(XP, 1, s, V2),
                            ld(Us, 0, n.mt, V2), ld(S, 0, n.mt, V2), ld(S, 1, n.mt, V2),
                            ld(XM, 0, s, V2), ld(XM, 1, s, V2), h0, h1);
    if (v != nullptr) {
      h0 = axpby(a, ld(v, 0, s, V2), b, h0);
      h1 = axpby(a, ld(v, 1, s, V2), b, h1);
    }
    st(out, 0, s, V2, h0);
    st(out, 1, s, V2, h1);
  }
  __syncthreads();
}

// out = (Dhat Dhat^+) v, the four hops of normal_apply through
// hop_stage_mxu; starts and ends with a barrier.
struct MxuNormalOp {
  const float *ue, *uo;
  float *t1, *t2, *t3, *W, *XP, *XM;
  const double *Pp, *Pm;
  float m, c;
  int Nx8;
  Geo g;
  __device__ __forceinline__ void operator()(const float* v, float* out) const {
    __syncthreads();
    hop_stage_mxu<true>(uo, ue, v, 1, t1, nullptr, 0.0f, 0.0f, W, XP, XM, Pp, Pm, Nx8, g);
    hop_stage_mxu<true>(ue, uo, t1, 0, t2, v, m, -c, W, XP, XM, Pp, Pm, Nx8, g);
    hop_stage_mxu<false>(uo, ue, t2, 1, t3, nullptr, 0.0f, 0.0f, W, XP, XM, Pp, Pm, Nx8, g);
    hop_stage_mxu<false>(ue, uo, t3, 0, out, t2, m, -c, W, XP, XM, Pp, Pm, Nx8, g);
  }
};

__global__ void __launch_bounds__(kThreads)
solve_mxu_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                 const float* __restrict__ b_all, const float* __restrict__ x0_all,
                 float* __restrict__ x_all, int* __restrict__ iters_out,
                 float* __restrict__ rho_out, float* __restrict__ bnorm_out,
                 float* __restrict__ scratch, int Nx, int Nth, float m, float c, double tol,
                 int max_iter) {
  extern __shared__ double perm[];
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2;
  const int Nx8 = (Nx + 7) / 8 * 8;
  double* Pp = perm;
  double* Pm = perm + Nx8 * perm_stride(Nx8);
  make_perm(Pp, Nx, Nx8, +1);
  make_perm(Pm, Nx, Nx8, -1);
  const int ch = blockIdx.x;
  float* sc = scratch + (size_t)ch * 44 * V2;
  float *ue = sc, *uo = sc + 4 * V2;
  make_links<float>(thE + (size_t)ch * 2 * V2, 0, ue, g);
  make_links<float>(thO + (size_t)ch * 2 * V2, 1, uo, g);
  MxuNormalOp op;
  op.ue = ue, op.uo = uo;
  op.t1 = sc + 20 * V2, op.t2 = sc + 24 * V2, op.t3 = sc + 28 * V2;
  op.W = sc + 32 * V2, op.XP = sc + 36 * V2, op.XM = sc + 40 * V2;
  op.Pp = Pp, op.Pm = Pm;
  op.m = m, op.c = c, op.Nx8 = Nx8, op.g = g;
  const CgOut o = cg_f32_op(op, b_all + (size_t)ch * 4 * V2, x0_all + (size_t)ch * 4 * V2,
                            x_all + (size_t)ch * 4 * V2, sc + 8 * V2, sc + 12 * V2,
                            sc + 16 * V2, tol, max_iter, g, sh);
  if (threadIdx.x == 0) {
    iters_out[ch] = o.iters;
    rho_out[ch] = o.rho;
    bnorm_out[ch] = o.bnorm2;
  }
}

// The shifts alone: out_p[p] = P+ in[p], out_m[p] = P- in[p], one block a
// plane. The proof that the product is exact is made on this entry.
__global__ void __launch_bounds__(kThreads)
shift_mxu_kernel(const float* __restrict__ in, float* __restrict__ out_p,
                 float* __restrict__ out_m, int Nx, int Nth) {
  extern __shared__ double perm[];
  const Geo g{Nx, Nth, Nx * Nth};
  const int Nx8 = (Nx + 7) / 8 * 8;
  double* Pp = perm;
  double* Pm = perm + Nx8 * perm_stride(Nx8);
  make_perm(Pp, Nx, Nx8, +1);
  make_perm(Pm, Nx, Nx8, -1);
  __syncthreads();
  const size_t off = (size_t)blockIdx.x * g.V2;
  shift_planes(Pp, in + off, out_p + off, 1, Nx8, g);
  shift_planes(Pm, in + off, out_m + off, 1, Nx8, g);
}

// Bytes of dynamic shared memory for the two one-hot matrices, and the
// kernel's opt-in to more than 48 KB of it.
template <typename K>
static int perm_shared(K kernel, int Nx, int* bytes) {
  const int Nx8 = (Nx + 7) / 8 * 8;
  *bytes = 2 * Nx8 * perm_stride(Nx8) * static_cast<int>(sizeof(double));
  if (*bytes > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
  if (*bytes > 48 * 1024)
    return static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes));
  return 0;
}

}  // namespace sm

extern "C" int solve_mxu_launch(const void* thE, const void* thO, const void* b, const void* x0,
                                void* x, void* iters, void* rho, void* bnorm, void* scratch,
                                int C, int Nx, int Nth, double m0, double tol, int max_iter,
                                void* stream) {
  const float m = static_cast<float>(m0 + 2.0);
  const float c = static_cast<float>(1.0 / (4.0 * (m0 + 2.0)));
  int bytes = 0;
  const int err = sm::perm_shared(sm::solve_mxu_kernel, Nx, &bytes);
  if (err != 0) return err;
  sm::solve_mxu_kernel<<<C, sm::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thE), static_cast<const float*>(thO),
      static_cast<const float*>(b), static_cast<const float*>(x0), static_cast<float*>(x),
      static_cast<int*>(iters), static_cast<float*>(rho), static_cast<float*>(bnorm),
      static_cast<float*>(scratch), Nx, Nth, m, c, tol, max_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shift_mxu_launch(const void* in, void* out_p, void* out_m, int n_planes, int Nx,
                                int Nth, void* stream) {
  int bytes = 0;
  const int err = sm::perm_shared(sm::shift_mxu_kernel, Nx, &bytes);
  if (err != 0) return err;
  sm::shift_mxu_kernel<<<n_planes, sm::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out_p), static_cast<float*>(out_m), Nx,
      Nth);
  return static_cast<int>(cudaGetLastError());
}
