// BLS12-381 G2 window table, window step and complete add, for Hopper (sm_90a).
//
// Kernel B4.  Replaces hydrabadger_tpu/ops/fq2_T.py:_pallas_table_call (B4a,
// `table`: the 16-entry w=4 table [inf, P, 2P, ..., 15P] by 14 chained complete
// adds) and _pallas_step_call (B4b, `step`: one window of the G2 ladder, 4
// doublings, the table entry the lane's digit names, a complete add), and adds
// `add`, the complete add alone, for the Lagrange combine's pairwise tree
// (composed XLA in ops/bls_g2_jax.g2_weighted_sum_windowed).  One thread per
// lane; operands are lane-fastest int32 batches (fp2_381.cuh): a point is
// [3, 2, 12, n], a table [16, 3, 2, 12, n] (entry-major, so one entry is
// contiguous across lanes), digits [n] int32.  Every output is canonical
// (< p), so each lane equals the JAX body's result bit for bit.
//
// What bounds it.  Fp Montgomery products (3 per Fp2 product, 2 per Fp2
// square): 60 per add (44 in the general formula and 16 in its doubling
// arm), 840 per table, 124 per step (4 x 16 + 60).  Bytes: 18 field elements of 48 bytes
// per lane for a step or an add, 102 for a table.  At the card's peaks (a
// product as int8 tensor-core work, PERF.md) operations bound all three
// entries.  This kernel does CIOS on the integer ALUs, 32-bit words with
// 64-bit products, so in practice the ALU issue rate and, with a G2 point
// of 72 words, register spills are its limits, far above either bound.
//
// What the design does about that.  Every intermediate stays in the thread
// (registers, and local memory where they spill); the step gathers the one
// entry its digit names (the TPU kernel summed all 16 entries times a
// one-hot mask for lack of a gather); the Fp2 product and square and the
// two point formulas are __noinline__ device functions shared by the three
// entries, which keeps the code small enough for the instruction cache and
// the build short.  A simple exact kernel first; PERF.md has its numbers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp2_381.cuh"

namespace {

using fp2_381::Pt2;

constexpr int kThreads = 128;
constexpr int kTable = 16;
constexpr int kDoublings = 4;
constexpr long long kPointWords = 6 * fp381::kWords;  // 72 words per point per lane

enum Kind { kTableKind = 0, kStep = 1, kAdd = 2 };

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    fq2_point_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     const int32_t* __restrict__ digits, uint32_t* __restrict__ out,
                     long long n) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  if constexpr (KIND == kTableKind) {  // a: P; out: the table
    const Pt2 p = fp2_381::load_pt(a, n, lane);
    fp2_381::store_pt(out, n, lane, fp2_381::infinity());
    fp2_381::store_pt(out + kPointWords * n, n, lane, p);
    Pt2 acc = p;
#pragma unroll 1
    for (int i = 2; i < kTable; ++i) {
      acc = fp2_381::jac_add(acc, p);
      fp2_381::store_pt(out + i * kPointWords * n, n, lane, acc);
    }
  } else if constexpr (KIND == kStep) {  // a: the accumulator; b: the table
    Pt2 acc = fp2_381::load_pt(a, n, lane);
#pragma unroll 1
    for (int i = 0; i < kDoublings; ++i) acc = fp2_381::jac_double(acc);
    const int d = digits[lane] & (kTable - 1);
    const Pt2 sel = fp2_381::load_pt(b + d * kPointWords * n, n, lane);
    fp2_381::store_pt(out, n, lane, fp2_381::jac_add(acc, sel));
  } else {  // kAdd
    fp2_381::store_pt(out, n, lane,
                      fp2_381::jac_add(fp2_381::load_pt(a, n, lane), fp2_381::load_pt(b, n, lane)));
  }
}

template <int KIND>
cudaError_t launch(const uint32_t* a, const uint32_t* b, const int32_t* digits, uint32_t* out,
                   long long n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fq2_point_kernel<KIND><<<blocks, kThreads, 0, stream>>>(a, b, digits, out, n);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream` over n lanes; returns cudaGetLastError() (0 on
// success).  kind: 0 table (a: [3, 2, 12, n] -> out [16, 3, 2, 12, n]),
// 1 step (a: the accumulator [3, 2, 12, n], b: its table, digits: [n] int32,
// each read & 15 -> out [3, 2, 12, n]), 2 add (a, b: [3, 2, 12, n] -> out).
// Every operand is contiguous with lane stride 1 and word stride n.
extern "C" int fq2_point_launch(int device, int kind, const void* a, const void* b,
                                const void* digits, void* out, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  const int32_t* pd = static_cast<const int32_t*>(digits);
  uint32_t* po = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kTableKind:
      return (int)launch<kTableKind>(pa, pb, pd, po, n, s);
    case kStep:
      if (pb == nullptr || pd == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<kStep>(pa, pb, pd, po, n, s);
    case kAdd:
      if (pb == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<kAdd>(pa, pb, pd, po, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fq2_point_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
