// BLS12-381 Fp2 arithmetic and Jacobian G2 formulas for one CUDA thread.
//
// Used by fq2_point.cu (kernel B4).  An Fp2 element is c0 + c1 u with
// u^2 = -1, two fp381::Fp (12 little-endian 32-bit words, Montgomery form,
// R = 2^384), always canonical (< p), so every result equals the JAX
// package's bit for bit.  A G2 point is Jacobian (x, y, z) over Fp2 on the
// twist y^2 = x^3 + 4(u + 1), z = 0 at infinity.
//
// Batches live in device memory lane-fastest, a point as six consecutive
// [12, n] blocks x0 x1 y0 y1 z0 z1: word w of element e of lane l is at
// base[(e * 12 + w) * n + l].
//
// The Fp2 product, the square and the two point formulas are __noinline__:
// a complete add is 60 Fp products, and inlining them all into every kernel made the
// code too large for the instruction cache and for a quick build.

#pragma once

#include "fp381.cuh"

namespace fp2_381 {

using fp381::Fp;

struct Fp2 {
  Fp c0, c1;
};

struct Pt2 {
  Fp2 x, y, z;
};

__device__ __forceinline__ Fp2 load(const uint32_t* base, long long n, long long lane) {
  return {fp381::load(base, n, lane), fp381::load(base + fp381::kWords * n, n, lane)};
}

__device__ __forceinline__ void store(uint32_t* base, long long n, long long lane,
                                      const Fp2& a) {
  fp381::store(base, n, lane, a.c0);
  fp381::store(base + fp381::kWords * n, n, lane, a.c1);
}

__device__ __forceinline__ Pt2 load_pt(const uint32_t* base, long long n, long long lane) {
  return {load(base, n, lane), load(base + 2 * fp381::kWords * n, n, lane),
          load(base + 4 * fp381::kWords * n, n, lane)};
}

__device__ __forceinline__ void store_pt(uint32_t* base, long long n, long long lane,
                                         const Pt2& p) {
  store(base, n, lane, p.x);
  store(base + 2 * fp381::kWords * n, n, lane, p.y);
  store(base + 4 * fp381::kWords * n, n, lane, p.z);
}

__device__ __forceinline__ bool is_zero(const Fp2& a) {
  return fp381::is_zero(a.c0) && fp381::is_zero(a.c1);
}

__device__ __forceinline__ Fp2 add(const Fp2& a, const Fp2& b) {
  return {fp381::add(a.c0, b.c0), fp381::add(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 sub(const Fp2& a, const Fp2& b) {
  return {fp381::sub(a.c0, b.c0), fp381::sub(a.c1, b.c1)};
}

// Karatsuba, 3 Fp products (fq2_T._fq2_mul): c0 = a0 b0 - a1 b1,
// c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1.
__device__ __noinline__ Fp2 mul(const Fp2 a, const Fp2 b) {
  const Fp t0 = fp381::mul(a.c0, b.c0);
  const Fp t1 = fp381::mul(a.c1, b.c1);
  const Fp cross = fp381::mul(fp381::add(a.c0, a.c1), fp381::add(b.c0, b.c1));
  return {fp381::sub(t0, t1), fp381::sub(fp381::sub(cross, t0), t1)};
}

// complex squaring, 2 Fp products: c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1
// (the same canonical value as mul(a, a), so the same bits)
__device__ __noinline__ Fp2 sqr(const Fp2 a) {
  const Fp c1 = fp381::mul(a.c0, a.c1);
  return {fp381::mul(fp381::add(a.c0, a.c1), fp381::sub(a.c0, a.c1)), fp381::add(c1, c1)};
}

// Jacobian infinity as the JAX package writes it: x = y = (one, 0), z = 0
// (R mod p, the Montgomery one)
__device__ __forceinline__ Pt2 infinity() {
  constexpr uint32_t kOne[fp381::kWords] = {
      0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
      0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
  Pt2 p;
#pragma unroll
  for (int i = 0; i < fp381::kWords; ++i) {
    p.x.c0.w[i] = kOne[i];
    p.x.c1.w[i] = 0u;
    p.y.c0.w[i] = kOne[i];
    p.y.c1.w[i] = 0u;
    p.z.c0.w[i] = 0u;
    p.z.c1.w[i] = 0u;
  }
  return p;
}

// fp381's two point formulas over Fp2, term for term (fq2_T's
// _jac2_double_body and _jac2_add_body).  The double does not
// short-circuit infinity: X and Y stay as the formula leaves them, Z = 0.
__device__ __noinline__ Pt2 jac_double(const Pt2& p) {
  const Fp2 a = sqr(p.x);
  const Fp2 b = sqr(p.y);
  const Fp2 c = sqr(b);
  const Fp2 t = add(p.x, b);
  Fp2 d = sub(sub(sqr(t), a), c);
  d = add(d, d);
  const Fp2 e = add(add(a, a), a);
  const Fp2 f = sqr(e);
  Pt2 out;
  out.x = sub(f, add(d, d));
  Fp2 c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  out.y = sub(mul(e, sub(d, out.x)), c8);
  const Fp2 yz = mul(p.y, p.z);
  out.z = add(yz, yz);
  return out;
}

// complete add: the selects of fq2_T._jac2_add_body in its order of
// precedence (p1 at infinity, p2 at infinity, p1 == p2, general); P + (-P)
// leaves the general result, whose z = z1 z2 h is 0
__device__ __noinline__ Pt2 jac_add(const Pt2& p1, const Pt2& p2) {
  if (is_zero(p1.z)) return p2;
  if (is_zero(p2.z)) return p1;
  const Fp2 z1z1 = sqr(p1.z);
  const Fp2 z2z2 = sqr(p2.z);
  const Fp2 u1 = mul(p1.x, z2z2);
  const Fp2 u2 = mul(p2.x, z1z1);
  const Fp2 s1 = mul(mul(p1.y, p2.z), z2z2);
  const Fp2 s2 = mul(mul(p2.y, p1.z), z1z1);
  const Fp2 h = sub(u2, u1);
  const Fp2 r = sub(s2, s1);
  if (is_zero(h) && is_zero(r)) return jac_double(p1);
  const Fp2 hh = sqr(h);
  const Fp2 hhh = mul(h, hh);
  const Fp2 v = mul(u1, hh);
  const Fp2 rr = sqr(r);
  Pt2 out;
  out.x = sub(sub(rr, hhh), add(v, v));
  out.y = sub(mul(r, sub(v, out.x)), mul(s1, hhh));
  out.z = mul(mul(p1.z, p2.z), h);
  return out;
}

}  // namespace fp2_381
