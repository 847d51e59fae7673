// BLS12-381 base-field arithmetic and Jacobian G1 formulas for one CUDA thread.
//
// Shared by fq_point.cu (kernel B2) and circuit.cu (kernel B3).  A field
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

struct Pt {
  Fp x, y, z;
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

__device__ __forceinline__ Pt load_pt(const uint32_t* base, long long n, long long lane) {
  return {load(base, n, lane), load(base + kWords * n, n, lane),
          load(base + 2 * kWords * n, n, lane)};
}

__device__ __forceinline__ void store_pt(uint32_t* base, long long n, long long lane,
                                         const Pt& p) {
  store(base, n, lane, p.x);
  store(base + kWords * n, n, lane, p.y);
  store(base + 2 * kWords * n, n, lane, p.z);
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

// The two point formulas of ops/fq_T (jac_double_formula and
// jac_add_core_formula), term for term.

__device__ __forceinline__ Pt jac_double(const Pt& p) {
  const Fp a = sqr(p.x);
  const Fp b = sqr(p.y);
  const Fp c = sqr(b);
  const Fp t = add(p.x, b);
  Fp d = sub(sub(sqr(t), a), c);
  d = add(d, d);
  const Fp e = add(add(a, a), a);
  const Fp f = sqr(e);
  Pt out;
  out.x = sub(f, add(d, d));
  Fp c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  out.y = sub(mul(e, sub(d, out.x)), c8);
  const Fp yz = mul(p.y, p.z);
  out.z = add(yz, yz);
  return out;
}

// the general add core; also returns h and r for the complete add's
// doubling case
__device__ __forceinline__ Pt jac_add_core(const Pt& p1, const Pt& p2, Fp& h, Fp& r) {
  const Fp z1z1 = sqr(p1.z);
  const Fp z2z2 = sqr(p2.z);
  const Fp u1 = mul(p1.x, z2z2);
  const Fp u2 = mul(p2.x, z1z1);
  const Fp s1 = mul(mul(p1.y, p2.z), z2z2);
  const Fp s2 = mul(mul(p2.y, p1.z), z1z1);
  h = sub(u2, u1);
  r = sub(s2, s1);
  const Fp hh = sqr(h);
  const Fp hhh = mul(h, hh);
  const Fp v = mul(u1, hh);
  const Fp rr = sqr(r);
  Pt out;
  out.x = sub(sub(rr, hhh), add(v, v));
  out.y = sub(mul(r, sub(v, out.x)), mul(s1, hhh));
  out.z = mul(mul(p1.z, p2.z), h);
  return out;
}

// incomplete ladder add: infinity on either side, no doubling case
__device__ __forceinline__ Pt jac_add_ladder(const Pt& p1, const Pt& p2) {
  if (is_zero(p1.z)) return p2;
  if (is_zero(p2.z)) return p1;
  Fp h, r;
  return jac_add_core(p1, p2, h, r);
}

// complete add: the selects of fq_T._jac_add_body in its order of
// precedence (p1 at infinity, p2 at infinity, p1 == p2, general)
__device__ __forceinline__ Pt jac_add(const Pt& p1, const Pt& p2) {
  if (is_zero(p1.z)) return p2;
  if (is_zero(p2.z)) return p1;
  Fp h, r;
  const Pt gen = jac_add_core(p1, p2, h, r);
  if (is_zero(h) && is_zero(r)) return jac_double(p1);
  return gen;
}

}  // namespace fp381
