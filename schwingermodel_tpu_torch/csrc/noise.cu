// The noise of one HMC trajectory, (pi, chi, r) of C chains in one launch,
// from a counter-based generator: Philox4x32-10 (Salmon, Moraes, Dror and
// Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC'11; the constants
// of Random123).
//
// Replaces what the JAX package draws inside its jitted trajectory:
// jax.random under jit (threefry keys folded per trajectory and split per
// chain, schwingermodel_tpu/utils/prng.py:28-35, drawn by
// schwingermodel_tpu/hmc/packed.py:478-488), an XLA operation and not a
// Pallas kernel. Here the trajectory index may live on the card (a 0-d
// int64 counter that a CUDA graph of the trajectory advances), which a
// host-seeded torch.Generator cannot follow.
//
// Layout (utils/prng.py holds the plain twin and says the same):
//   key     k0 = seed mod 2^32, k1 = (seed >> 32) mod 2^24 | tag << 24;
//   counter c0 = q, the pair or element index within the field,
//           c1 = field | (trajectory >> 32) << 8   (field 0 pi, 1 chi, 2 r),
//           c2 = the chain's global index (chain_offset + chain),
//           c3 = trajectory mod 2^32.
// One counter gives one Box-Muller pair: u1 = (m1 + 1) 2^-53 in (0, 1] and
// u2 = m2 2^-53 in [0, 1) from the 53 high bits of the 64-bit words
// (w1 w0) and (w3 w2); z0 = sqrt(-2 log u1) cos(2 pi u2), z1 = ... sin, in
// f64, rounded once to the working type. pi takes (z0, z1) as the elements
// 2q and 2q + 1 of a chain; chi's element q is (z0, z1) / sqrt(2); r is
// m1 2^-53 in f64, or its top 24 bits times 2^-24 in f32 (exact in both, and
// below 1).
//
// What bounds it on the card: the bytes it writes (pi and chi, 2 MiB at
// 64x64 C=32, ~0.6 us at 3.35 TB/s) against ten Philox rounds and an f64
// log, sin and cos per pair: one thread a pair, a grid of chains x pairs,
// no shared memory, every store coalesced.
//
// The Z2 mode (z2_kernel): the condensate's Z2xZ2 noise of one measurement,
// n_noise vectors of 2 Nx Nt complex64 entries (+-1 +- i)/sqrt(2) for C
// chains, replacing what the JAX runner draws inside its jitted measurement
// (jax.random under jit, schwingermodel_tpu/runner.py:253-258, and
// schwingermodel_tpu/observables.py condensate_noise): the key of stream
// tag 2 (_MEAS), so never a (key, counter) of the trajectory stream (tag
// 1), and the measurement index read on the card where a CUDA graph of the
// measurement advances it.
//   counter c0 = q, the group of 4 elements of one vector,
//           c1 = the vector j | (measurement >> 32) << 16,
//           c2 = the chain's global index, c3 = measurement mod 2^32;
// element 4q + k takes word w_k: real part -f32(2^-1/2) where bit 31 is
// set, else +f32(2^-1/2); imaginary part the same by bit 30. One thread a
// counter writes its 32 bytes in two 16-byte stores; the bound is those
// bytes (16.8 MB at 64x64 C=32, 8 vectors: 5.0 us at 3.35 TB/s), ten Philox
// rounds a counter beside them.
#include <cstdint>
#include <cuda_runtime.h>

namespace noise {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr double kTwoPi = 6.283185307179586;        // f64(2 pi)
constexpr double kSqrtHalf = 0.7071067811865476;    // f64(2^-1/2)
constexpr double kTwoM53 = 0x1p-53;
constexpr float kTwoM24 = 0x1p-24f;
constexpr float kZ2 = 0x1.6a09e6p-1f;                 // f32(2^-1/2)
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// the 53 high bits of the 64-bit word (hi lo)
__device__ __forceinline__ uint64_t bits53(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 21) | (lo >> 11);
}

// Raw Philox words of n counters [n, 4] under one key, for the known-answer
// vectors and the word-for-word check against the twin.
__global__ void philox_kernel(const uint32_t* __restrict__ ctr, uint2 key,
                              uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 w = philox4x32_10(
      make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]), key);
  out[4 * i] = w.x;
  out[4 * i + 1] = w.y;
  out[4 * i + 2] = w.z;
  out[4 * i + 3] = w.w;
}

template <typename Real>
__global__ void __launch_bounds__(kThreads)
noise_kernel(const long long* __restrict__ traj_ptr, long long traj_value, uint2 key,
             long long chain_offset, int n_pairs, int n_chi, Real* __restrict__ pi,
             Real* __restrict__ chi, Real* __restrict__ r, uint32_t* __restrict__ words) {
  const int chain = blockIdx.y;
  const int n_ctr = n_pairs + n_chi + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_ctr) return;
  const unsigned long long traj =
      static_cast<unsigned long long>(traj_ptr ? *traj_ptr : traj_value);
  int field = 0, q = i;
  if (i >= n_pairs + n_chi) {
    field = 2;
    q = 0;
  } else if (i >= n_pairs) {
    field = 1;
    q = i - n_pairs;
  }
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q),
                 static_cast<uint32_t>(field) | static_cast<uint32_t>(traj >> 32) << 8,
                 static_cast<uint32_t>(chain_offset + chain), static_cast<uint32_t>(traj)),
      key);
  if (words) {
    uint32_t* o = words + 4 * (static_cast<size_t>(chain) * n_ctr + i);
    o[0] = w.x;
    o[1] = w.y;
    o[2] = w.z;
    o[3] = w.w;
  }
  const uint64_t m1 = bits53(w.x, w.y);
  if (field == 2) {
    if constexpr (sizeof(Real) == 8)
      r[chain] = static_cast<Real>(static_cast<double>(m1) * kTwoM53);
    else
      r[chain] = static_cast<Real>(static_cast<float>(m1 >> 29) * kTwoM24);
    return;
  }
  const double u1 = static_cast<double>(m1 + 1) * kTwoM53;
  const double u2 = static_cast<double>(bits53(w.z, w.w)) * kTwoM53;
  const double rad = sqrt(-2.0 * log(u1));
  const double ang = kTwoPi * u2;
  const double z0 = rad * cos(ang);
  const double z1 = rad * sin(ang);
  Real* out = field == 0 ? pi + 2 * (static_cast<size_t>(chain) * n_pairs + q)
                         : chi + 2 * (static_cast<size_t>(chain) * n_chi + q);
  if (field == 0) {
    out[0] = static_cast<Real>(z0);
    out[1] = static_cast<Real>(z1);
  } else {
    out[0] = static_cast<Real>(z0 * kSqrtHalf);
    out[1] = static_cast<Real>(z1 * kSqrtHalf);
  }
}

// The Z2 mode: block (x, j, chain), one thread a counter q of vector j.
__global__ void __launch_bounds__(kThreads)
z2_kernel(const long long* __restrict__ meas_ptr, long long meas_value, uint2 key,
          long long chain_offset, int n_el, float2* __restrict__ z,
          uint32_t* __restrict__ words) {
  const int n_groups = (n_el + 3) / 4;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_groups) return;
  const int j = blockIdx.y, chain = blockIdx.z;
  const unsigned long long meas =
      static_cast<unsigned long long>(meas_ptr ? *meas_ptr : meas_value);
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q),
                 static_cast<uint32_t>(j) | static_cast<uint32_t>(meas >> 32) << 16,
                 static_cast<uint32_t>(chain_offset + chain), static_cast<uint32_t>(meas)),
      key);
  const size_t vec = static_cast<size_t>(chain) * gridDim.y + j;
  if (words) {
    uint32_t* o = words + 4 * (vec * n_groups + q);
    o[0] = w.x;
    o[1] = w.y;
    o[2] = w.z;
    o[3] = w.w;
  }
  const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
  float v[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = ww[k] >> 31 ? -kZ2 : kZ2;
    v[2 * k + 1] = (ww[k] >> 30) & 1u ? -kZ2 : kZ2;
  }
  float2* out = z + vec * n_el + 4 * static_cast<size_t>(q);
  if (n_el % 4 == 0) {  // 32-byte aligned: two 16-byte stores
    float4* o4 = reinterpret_cast<float4*>(out);
    o4[0] = make_float4(v[0], v[1], v[2], v[3]);
    o4[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  for (int k = 0; k < 4 && 4 * q + k < n_el; ++k) out[k] = make_float2(v[2 * k], v[2 * k + 1]);
}

}  // namespace noise

// (pi, chi, r) of C chains: pi [C, 2 n_pairs], chi [C, n_chi] complex
// (interleaved re, im), r [C], f32 (f64 = 0) or f64; the trajectory index
// read from traj (an int64 on the card) or, where traj is null, traj_value;
// words, where not null, uint32 [C, n_pairs + n_chi + 1, 4].
extern "C" int noise_launch(const void* traj, long long traj_value, unsigned int key0,
                            unsigned int key1, long long chain_offset, void* pi, void* chi,
                            void* r, void* words, int C, int n_pairs, int n_chi, int f64,
                            void* stream) {
  if (C < 1 || n_pairs < 1 || n_chi < 1 || C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ctr = n_pairs + n_chi + 1;
  const dim3 grid((n_ctr + noise::kThreads - 1) / noise::kThreads, C);
  const uint2 key = make_uint2(key0, key1);
  const long long* tp = static_cast<const long long*>(traj);
  uint32_t* w = static_cast<uint32_t*>(words);
  if (f64)
    noise::noise_kernel<double><<<grid, noise::kThreads, 0, s>>>(
        tp, traj_value, key, chain_offset, n_pairs, n_chi, static_cast<double*>(pi),
        static_cast<double*>(chi), static_cast<double*>(r), w);
  else
    noise::noise_kernel<float><<<grid, noise::kThreads, 0, s>>>(
        tp, traj_value, key, chain_offset, n_pairs, n_chi, static_cast<float*>(pi),
        static_cast<float*>(chi), static_cast<float*>(r), w);
  return static_cast<int>(cudaGetLastError());
}

// The Z2 mode: z complex64 [C, n_noise, n_el] (interleaved re, im) of one
// measurement, its index read from meas (an int64 on the card) or, where meas
// is null, meas_value; words, where not null, uint32 [C, n_noise,
// ceil(n_el / 4), 4].
extern "C" int z2_launch(const void* meas, long long meas_value, unsigned int key0,
                         unsigned int key1, long long chain_offset, void* z, void* words, int C,
                         int n_noise, int n_el, void* stream) {
  if (C < 1 || C > 65535 || n_noise < 1 || n_noise > 65535 || n_el < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((n_el + 3) / 4 + noise::kThreads - 1) / noise::kThreads, n_noise, C);
  noise::z2_kernel<<<grid, noise::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(meas), meas_value, make_uint2(key0, key1), chain_offset,
      n_el, static_cast<float2*>(z), static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

// Philox4x32-10 of n counters uint32 [n, 4] under (key0, key1) into out [n, 4].
extern "C" int philox_launch(const void* ctr, unsigned int key0, unsigned int key1, void* out,
                             int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  noise::philox_kernel<<<(n + noise::kThreads - 1) / noise::kThreads, noise::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), make_uint2(key0, key1), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
