// Fp probes for Hopper (sm_90a): what one thread-per-lane Montgomery product
// costs on this card, in four small kernels.
//
// Replaces the Pallas prototypes that measured the TPU's field-arithmetic floor:
//   E1 experiments/pallas_fq.py:87 make_fq_mul_pallas        -> entry `mul`
//   E2 experiments/prof_mul_variants.py:44 make_kernel        -> entry `chain`
//   E3 experiments/prof_mix_vs_mul.py:60 make_mulonly         -> entry `mul_layer`
//   E4 experiments/prof_fixed_cost.py:27 make_noop            -> entry `noop`
// The product is fp381.cuh's CIOS over 32-bit words, the code that kernels B2,
// B3 and B4 run, so a probe's time is theirs per product.  Layout: [12, n]
// 32-bit words, lane-fastest, Montgomery form with R = 2^384, every Fp output
// canonical (< p).
//
// The entries:
//   mul        out = a*b/R mod p, one lane per thread, `threads` per block
//              (E1's block width, 64-512).
//   chain      `iters` dependent x = body(x, b) inside one kernel, one lane per
//              thread (E2).  Bodies:
//                full     fp381::mul;
//                fdigit   the same Montgomery product with its schoolbook on the
//                         FP64 pipe (below), bit-exact to `full`;
//                product  the unreduced schoolbook's low 384 bits, a*b mod 2^384
//                         (the nearest value-level counterpart of E2's
//                         "convolution only + mask", which is a layout artifact);
//                carry    (a + b) mod 2^384 over 12 words (E2's `carry only`).
//   mul_layer  one canonical product per lane of a stacked [12, 2W] operand:
//              lane l multiplies column l by column W + l, reading the words
//              as circuit.cu's multiply layer reads its scratch (lane-fastest,
//              word stride 2W); out [12, W] (E3).
//   noop       out = x + inner on int32 words (E4's fixed cost of a launch).
//
// fdigit's exactness.  Hopper has no native multiply wider than 32 bits.  FP64
// carries a 53-bit significand: with 24-bit digits (16 of them span 384 bits)
// every digit product is < 2^48 and a column of the schoolbook sums at most 16
// of them, < 2^52 < 2^53, so every fma is exact and each column is an exact
// integer.  The 31 columns are carried into 24 words (a 768-bit integer) and
// reduced by word-serial Montgomery (SOS): 12 rounds of m = t_i * (-p^-1) mod
// 2^32 and t += m*p*2^(32 i), then one conditional subtraction.  The same
// value, so the same canonical bits, as `full`.  (FP32 would need digits of
// at most 8 bits for sums of 48 products below 2^24: 2304 fmas per product.)
//
// What bounds them.  The bound of a probe is the larger of its bytes (48 B per
// field element read or written once, at 3.35 TB/s) and its operations (11,568
// int8 tensor-core ops per Montgomery product at 1,979 TOP/s, the cheapest
// exact form counted in PERF.md; 2,352 for `product`'s low half).  At these
// shapes bytes bound `mul`, `mul_layer` and `noop` and operations bound a long
// `chain`.  What the design does: nothing beyond what B2 does (registers only,
// coalesced word loads) -- these are measurements of that design, not a
// faster one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381.cuh"

namespace {

using fp381::Fp;
using fp381::kP;
using fp381::kPInv0;
using fp381::kWords;

enum Kind { kMul = 0, kChain = 1, kMulLayer = 2, kNoop = 3 };
enum Body { kFull = 0, kFdigit = 1, kProduct = 2, kCarry = 3 };

constexpr int kChainThreads = 128;
constexpr int kMaxThreads = 512;
constexpr int kDigitBits = 24;
constexpr int kDigits = 16;  // 16 x 24 = 384 bits
constexpr uint32_t kDigitMask = (1u << kDigitBits) - 1u;

// a -> 16 little-endian 24-bit digits as doubles
__device__ __forceinline__ void to_digits(const Fp& a, double* d) {
#pragma unroll
  for (int k = 0; k < kDigits; ++k) {
    const int bit = kDigitBits * k;
    const int w = bit >> 5;
    const int s = bit & 31;
    uint64_t v = (uint64_t)a.w[w] >> s;
    if (s > 32 - kDigitBits) v |= (uint64_t)a.w[w + 1] << (32 - s);
    d[k] = (double)(uint32_t)(v & kDigitMask);
  }
}

// Montgomery product with the schoolbook on the FP64 pipe (see the note above)
__device__ __forceinline__ Fp mul_fdigit(const Fp& a, const Fp& b) {
  double da[kDigits], db[kDigits], col[2 * kDigits - 1];
  to_digits(a, da);
  to_digits(b, db);
#pragma unroll
  for (int k = 0; k < 2 * kDigits - 1; ++k) col[k] = 0.0;
#pragma unroll
  for (int i = 0; i < kDigits; ++i) {
#pragma unroll
    for (int j = 0; j < kDigits; ++j) col[i + j] = fma(da[i], db[j], col[i + j]);
  }
  // the columns -> 32 24-bit digits -> 24 words of the 768-bit product
  uint32_t t[2 * kWords];
  uint64_t acc = 0;
  uint32_t e[4];
#pragma unroll
  for (int g = 0; g < 2 * kDigits / 4; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * g + r;
      if (k < 2 * kDigits - 1) acc += (uint64_t)col[k];  // exact: col < 2^52
      e[r] = (uint32_t)acc & kDigitMask;
      acc >>= kDigitBits;
    }
    t[3 * g] = e[0] | (e[1] << 24);
    t[3 * g + 1] = (e[1] >> 8) | (e[2] << 16);
    t[3 * g + 2] = (e[2] >> 16) | (e[3] << 8);
  }
  // word-serial Montgomery reduction; hi is the carry pending at word i + 12
  uint32_t hi = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t m = t[i] * kPInv0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t s = (uint64_t)m * kP[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t s = (uint64_t)t[i + kWords] + c + hi;
    t[i + kWords] = (uint32_t)s;
    hi = (uint32_t)(s >> 32);
  }
  Fp r;  // (a b + m p) / R < 2p < 2^383: hi is 0
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = t[kWords + i];
  return fp381::reduce_once(r);
}

// a*b mod 2^384: the low half of the schoolbook (78 word products)
__device__ __forceinline__ Fp mul_low(const Fp& a, const Fp& b) {
  Fp t = fp381::zero();
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; i + j < kWords; ++j) {
      const uint64_t s = (uint64_t)a.w[j] * b.w[i] + t.w[i + j] + c;
      t.w[i + j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  return t;
}

// (a + b) mod 2^384
__device__ __forceinline__ Fp add_wrap(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return s;
}

template <int BODY>
__device__ __forceinline__ Fp body(const Fp& x, const Fp& b) {
  if constexpr (BODY == kFull) return fp381::mul(x, b);
  if constexpr (BODY == kFdigit) return mul_fdigit(x, b);
  if constexpr (BODY == kProduct) return mul_low(x, b);
  return add_wrap(x, b);
}

__global__ void __launch_bounds__(kMaxThreads)
    mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fp381::store(out, n, lane, fp381::mul(fp381::load(a, n, lane), fp381::load(b, n, lane)));
}

template <int BODY>
__global__ void __launch_bounds__(kChainThreads)
    chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, long long n, int iters) {
  const long long lane = (long long)blockIdx.x * kChainThreads + threadIdx.x;
  if (lane >= n) return;
  Fp v = fp381::load(x, n, lane);
  const Fp c = fp381::load(b, n, lane);
  for (int i = 0; i < iters; ++i) v = body<BODY>(v, c);
  fp381::store(out, n, lane, v);
}

// x: [12, 2W] stacked (left half, right half), out: [12, W]
__global__ void __launch_bounds__(kMaxThreads)
    mul_layer_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, long long w) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= w) return;
  const Fp l = fp381::load(x, 2 * w, lane);
  const Fp r = fp381::load(x, 2 * w, w + lane);
  fp381::store(out, w, lane, fp381::mul(l, r));
}

__global__ void __launch_bounds__(kMaxThreads)
    noop_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                int inner) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t v = x[i];
  for (int k = 0; k < inner; ++k) v += 1;
  out[i] = v;
}

unsigned blocks_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <int BODY>
cudaError_t launch_chain(const uint32_t* x, const uint32_t* b, uint32_t* out, long long n,
                         int iters, cudaStream_t s) {
  chain_kernel<BODY><<<blocks_of(n, kChainThreads), kChainThreads, 0, s>>>(x, b, out, n, iters);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`; returns cudaGetLastError() (0 on success).
//   kind 0 mul:       a, b, out [12, n]; `threads` per block (32..512, a multiple of 32)
//   kind 1 chain:     a (x), b, out [12, n]; `body` 0 full, 1 fdigit, 2 product,
//                     3 carry; `iters` >= 0 chained bodies
//   kind 2 mul_layer: a [12, 2n] stacked, out [12, n]; `threads` per block
//   kind 3 noop:      a, out n int32; out = a + iters
// Every operand is contiguous, lane stride 1.
extern "C" int fp_probe_launch(int device, int kind, int body, int iters, int threads,
                               const void* a, const void* b, void* out, long long n,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return (int)cudaErrorInvalidValue;
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kMul:
      mul_kernel<<<blocks_of(n, threads), threads, 0, s>>>(pa, pb, po, n);
      return (int)cudaGetLastError();
    case kChain:
      switch (body) {
        case kFull:
          return (int)launch_chain<kFull>(pa, pb, po, n, iters, s);
        case kFdigit:
          return (int)launch_chain<kFdigit>(pa, pb, po, n, iters, s);
        case kProduct:
          return (int)launch_chain<kProduct>(pa, pb, po, n, iters, s);
        case kCarry:
          return (int)launch_chain<kCarry>(pa, pb, po, n, iters, s);
        default:
          return (int)cudaErrorInvalidValue;
      }
    case kMulLayer:
      mul_layer_kernel<<<blocks_of(n, threads), threads, 0, s>>>(pa, po, n);
      return (int)cudaGetLastError();
    case kNoop:
      noop_kernel<<<blocks_of(n, threads), threads, 0, s>>>(
          static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n, iters);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fp_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
