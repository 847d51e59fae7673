// BLS12-381 G2 window table, window step, complete add and whole ladder, for
// Hopper (sm_90a).
//
// Kernel B4.  Replaces hydrabadger_tpu/ops/fq2_T.py:_pallas_table_call (B4a,
// `table`: the 16-entry w=4 table [inf, P, 2P, ..., 15P] by 14 chained complete
// adds) and _pallas_step_call (B4b, `step`: one window of the G2 ladder, 4
// doublings, the table entry the lane's digit names, a complete add), and adds
// `add`, the complete add alone, for the Lagrange combine's pairwise tree
// (composed XLA in ops/bls_g2_jax.g2_weighted_sum_windowed), and `ladder`, a
// whole fixed-window scalar multiplication (bls_g2_jax.g2_scalar_mul_windowed:
// the table, then per window 4 doublings and a complete add) in one launch.
// Operands are lane-fastest int32 batches (fp381.cuh): a point is
// [3, 2, 12, n] (six Fp elements x0 x1 y0 y1 z0 z1), a table [16, 3, 2, 12, n]
// (entry-major, so one entry is contiguous across lanes), digits int32.  Every
// output is canonical (< p), so each lane equals the JAX body's result bit
// for bit.
//
// What bounds it.  Fp Montgomery products (3 per Fp2 product, 2 per Fp2
// square): 16 per double, 44 in the add's general formula; a coin round's
// ladders need ~4,100 per lane.  At the card's peaks (a product as int8
// tensor-core work, ops/roofline.py) operations bound every entry.  In
// practice CIOS on the integer ALUs at 1408-4096 lanes is bound by the
// latency of a lane's chain of dependent products: a thread that walks a
// window's 124 products in order, at one warp per SMSP, waits on each.
//
// What the design does about that (point_block.cuh).  A block is 32 lanes x
// T warps (T = 8, the add's widest layer of 13 products); each formula is a
// layered program (ops/point_block.py) and warp t computes products t,
// t + T, ... of a layer, so a window costs its ~19 layer-steps instead of 124
// dependent products; wires live in shared-memory slots.  The ladder keeps
// the accumulator in the slots for its 64 windows, writes its table to a
// device scratch the same block reads back, and gathers each window's entry
// with cp.async while the block doubles: one launch per ladder instead of 65.

#include <cuda_runtime.h>
#include <stdint.h>

#include "point_block.cuh"

namespace {

using Pts = point_block::Points<2>;

constexpr int K = Pts::K;  // 6 Fp elements per point
constexpr int kDoublings = 4;

enum Kind { kTableKind = 0, kStep = 1, kAdd = 2, kLadder = 3 };

template <int KIND>
__global__ void __launch_bounds__(32 * point_block::kMaxWarps)
    fq2_point_kernel(const int* __restrict__ set_g, int set_len, const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, const int32_t* __restrict__ digits,
                     int windows, uint32_t* table, uint32_t* __restrict__ out, long long n) {
  extern __shared__ uint32_t smem[];
  const Pts pts = point_block::stage<2>(smem, set_g, set_len, n);
  if constexpr (KIND == kTableKind) {  // a: P; out: the table
    pts.load(K, a);
    __syncthreads();
    pts.build_table(out, K);
  } else if constexpr (KIND == kStep) {  // a: the accumulator; b: its table
    pts.load(0, a);
    pts.fetch(K, b, K, pts.live ? digits[pts.g] & (point_block::kTable - 1) : 0, 0);
    __syncthreads();
    pts.doublings(kDoublings);
    __pipeline_wait_prior(0);
    __syncthreads();
    pts.add(0, true);
    pts.store(out);
  } else if constexpr (KIND == kAdd) {
    pts.load(0, a);
    pts.load(K, b);
    __syncthreads();
    pts.add(0, true);
    pts.store(out);
  } else {  // kLadder: a: P; digits: [windows, n]; table: the scratch [16, 6, 12, n]
    pts.load(K, a);
    __syncthreads();
    pts.build_table(table, K);
    pts.infinity();
    for (int j = 0; j < windows; ++j) {
      const int d = pts.live ? digits[j * n + pts.g] & (point_block::kTable - 1) : 0;
      pts.fetch(K, table, K, d, 0);
      pts.doublings(kDoublings);
      __pipeline_wait_prior(0);
      __syncthreads();
      pts.add(0, true);
    }
    pts.store(out);
  }
}

template <int KIND>
cudaError_t launch(int device, const int* set, int set_len, int smem, int warps,
                   const uint32_t* a, const uint32_t* b, const int32_t* digits, int windows,
                   uint32_t* table, uint32_t* out, long long n, cudaStream_t stream) {
  cudaError_t err = point_block::prepare(fq2_point_kernel<KIND>, device, smem, warps);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + 31) / 32);
  fq2_point_kernel<KIND><<<blocks, 32 * warps, smem, stream>>>(set, set_len, a, b, digits,
                                                               windows, table, out, n);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream` over n lanes; returns cudaGetLastError() (0 on
// success).  `set` (set_len int32 on the device) is the program set of
// ops/point_block.py, `smem` the bytes of shared memory a block takes,
// `warps` the warps per block.  kind: 0 table (a: [3, 2, 12, n] -> out
// [16, 3, 2, 12, n]), 1 step (a: the accumulator, b: its table, digits: [n],
// each read & 15 -> out [3, 2, 12, n]), 2 add (a, b: [3, 2, 12, n] -> out),
// 3 ladder (a: the points, digits: [windows, n] MSB first, table: a
// [16, 3, 2, 12, n] scratch -> out).  Every operand is contiguous with lane
// stride 1 and word stride n.
extern "C" int fq2_point_launch(int device, int kind, const void* set, int set_len, int smem,
                                int warps, const void* a, const void* b, const void* digits,
                                int windows, void* table, void* out, long long n, void* stream) {
  if (n <= 0 || set == nullptr || set_len < 1) return (int)cudaErrorInvalidValue;
  const int* ps = static_cast<const int*>(set);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  const int32_t* pd = static_cast<const int32_t*>(digits);
  uint32_t* pt = static_cast<uint32_t*>(table);
  uint32_t* po = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kTableKind:
      return (int)launch<kTableKind>(device, ps, set_len, smem, warps, pa, pb, pd, windows, pt,
                                     po, n, s);
    case kStep:
      if (pb == nullptr || pd == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<kStep>(device, ps, set_len, smem, warps, pa, pb, pd, windows, pt, po,
                                n, s);
    case kAdd:
      if (pb == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<kAdd>(device, ps, set_len, smem, warps, pa, pb, pd, windows, pt, po, n,
                               s);
    case kLadder:
      if (pd == nullptr || pt == nullptr || windows < 0) return (int)cudaErrorInvalidValue;
      return (int)launch<kLadder>(device, ps, set_len, smem, warps, pa, pb, pd, windows, pt, po,
                                  n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fq2_point_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
