// K9: the f64 true residual r = b - (Dhat Dhat^+) x of the restart
// refinement.
//
// Replaces schwingermodel_tpu/ops/pallas_df.py:_df_residual_kernel
// (df_residual_fused): the TPU kernel evaluates the links and the apply in
// double-float from the f32 angles; the card has native f64, so the links
// are sincos((double)theta) (make_links<double>, the antiperiodic sign
// folded in) and the apply is normal_apply<double>. Inputs per entry
// (configuration c, right-hand side j; block e = c * B + j): the angle
// planes of c, b in f32 and x in f64; outputs r in f64 and its f64
// ||r||^2, which the refinement's stop and stagnation tests read next.
//
// What bounds it on the card: one f64 normal apply (4 dependent stencil
// stages at half the f32 rate) and one block reduction on 2048 sites per
// entry at 64x64: latency, as the solvers. One thread block per entry; each
// builds its configuration's f64 links into its own scratch (20 f64 values
// per half-lattice site: links and the three stencil temporaries), so no
// cross-block step is needed.
#include "stencil.cuh"

namespace sm {

constexpr int kResidualScratch = 20;  // f64 values per half-lattice site and entry

__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ thE, const float* __restrict__ thO,
                const float* __restrict__ b_all, const double* __restrict__ x_all,
                double* __restrict__ r_all, double* __restrict__ rnorm_out,
                double* __restrict__ scratch, int B, int Nx, int Nth, double m, double c) {
  __shared__ double sh[33];
  const Geo g{Nx, Nth, Nx * Nth};
  const int V2 = g.V2, n = 4 * V2;
  const int e = blockIdx.x;
  const int cfg = e / B;
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

}  // namespace sm

extern "C" int residual_launch(const void* thE, const void* thO, const void* b, const void* x,
                               void* r, void* rnorm, void* scratch, int C, int B, int Nx, int Nth,
                               double m0, void* stream) {
  const double m = m0 + 2.0, c = 1.0 / (4.0 * (m0 + 2.0));
  sm::residual_kernel<<<C * B, sm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thE), static_cast<const float*>(thO),
      static_cast<const float*>(b), static_cast<const double*>(x), static_cast<double*>(r),
      static_cast<double*>(rnorm), static_cast<double*>(scratch), B, Nx, Nth, m, c);
  return static_cast<int>(cudaGetLastError());
}
