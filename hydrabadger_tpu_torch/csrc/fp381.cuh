// BLS12-381 base-field arithmetic for one CUDA thread.
//
// Shared by fq_point.cu (kernel B2), circuit.cu (kernel B3), fq2_point.cu
// (kernel B4, through point_block.cuh) and fp_probe.cu.  A field
// element is 12 little-endian 32-bit words in Montgomery form with
// R = 2^384 (the JAX package's R too), always canonical (< p) between
// operations, so every result equals the JAX package's bit for bit.
//
// Batches live in device memory lane-fastest: word w of element e of lane
// l is at base[(e * 12 + w) * n + l], so the threads of a warp (neighbouring
// lanes) read neighbouring words.

#pragma once

#include <stdint.h>

namespace fp381 {

constexpr int kWords = 12;

__constant__ uint32_t kP[kWords] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
constexpr uint32_t kPInv0 = 0xfffcfffdu;  // -p^-1 mod 2^32

struct Fp {
  uint32_t w[kWords];
};

// (no restrict qualifiers: circuit.cu reads back what it stored in one launch)
__device__ __forceinline__ Fp load(const uint32_t* base, long long n, long long lane) {
  Fp a;
#pragma unroll
  for (int i = 0; i < kWords; ++i) a.w[i] = base[i * n + lane];
  return a;
}

__device__ __forceinline__ void store(uint32_t* base, long long n, long long lane,
                                      const Fp& a) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) base[i * n + lane] = a.w[i];
}

__device__ __forceinline__ Fp zero() {
  Fp a;
#pragma unroll
  for (int i = 0; i < kWords; ++i) a.w[i] = 0u;
  return a;
}

__device__ __forceinline__ bool is_zero(const Fp& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) acc |= a.w[i];
  return acc == 0u;
}

// a - p if a >= p, else a (a < 2^384)
__device__ __forceinline__ Fp reduce_once(const Fp& a) {
  Fp d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t s = (uint64_t)a.w[i] - kP[i] - borrow;
    d.w[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  return borrow ? a : d;
}

__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once(s);  // a + b < 2p < 2^382: no carry out
}

__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  Fp d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t s = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      c += (uint64_t)d.w[i] + kP[i];
      d.w[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

// Montgomery product a*b/R mod p, CIOS over 32-bit words (the form of
// native/bls12_381.cpp with 64-bit limbs), canonical output.
__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int i = 0; i < kWords + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kPInv0;
    s = (uint64_t)m * kP[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = (uint64_t)m * kP[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
  Fp r;  // t < 2p < 2^384: t[12] is 0
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = t[i];
  return reduce_once(r);
}

__device__ __forceinline__ Fp sqr(const Fp& a) { return mul(a, a); }

}  // namespace fp381
