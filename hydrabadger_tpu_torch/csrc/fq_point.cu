// BLS12-381 Fp Montgomery product and Jacobian G1 point ops, for Hopper (sm_90a).
//
// Replaces hydrabadger_tpu/ops/fq_T.py:_pallas_point_call (kernel B2) and its
// bodies: `mul` (_mul_rows; also by one element for every lane), `dbl`
// (_jac_double_body), `add` (the complete _jac_add_body), `ladd` (the
// incomplete _jac_add_ladder_body), `dblk{k}` (k chained doublings) and
// `win{k}` (one GLV window: k doublings and two ladder adds).  One thread per lane; operands and result are [.., 12, n] int32
// batches laid out lane-fastest (fp381.cuh), every output canonical (< p), so
// each lane equals the JAX body's result bit for bit.
//
// What bounds it.  The work is Montgomery products: 1 (mul), 7 (dbl), 16
// (ladd), 23 (add), 7k (dblk), 7k + 32 (win) per lane; the bytes are the
// field elements read and written, 48 bytes each (2-3 for mul, 6 for dbl, 9
// for add and ladd).  At the card's peaks (a product as int8 tensor-core
// work, PERF.md) bytes bound every entry on the decrypt path but the
// 23-product complete `add`.  This kernel does CIOS on the integer ALUs,
// 32-bit words with 64-bit products, so in practice the ALU issue rate is
// its limit, far above either bound.
//
// What the design does about that.  Nothing yet beyond keeping every value
// in registers for the whole body (a point op never round-trips device
// memory, as the TPU kernel keeps its intermediates in VMEM) and coalesced
// word loads.  A simple exact kernel first; PERF.md has its numbers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381.cuh"

namespace {

using fp381::Pt;

constexpr int kThreads = 128;

enum Kind { kMul = 0, kDbl = 1, kAdd = 2, kLadd = 3, kDblk = 4, kWin = 5, kMulC = 6 };

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    fq_point_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
                    long long n, int k) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  if constexpr (KIND == kMul) {
    fp381::store(out, n, lane, fp381::mul(fp381::load(a, n, lane), fp381::load(b, n, lane)));
  } else if constexpr (KIND == kMulC) {  // b: one element, the same for every lane
    fp381::store(out, n, lane, fp381::mul(fp381::load(a, n, lane), fp381::load(b, 1, 0)));
  } else if constexpr (KIND == kDbl) {
    fp381::store_pt(out, n, lane, fp381::jac_double(fp381::load_pt(a, n, lane)));
  } else if constexpr (KIND == kAdd) {
    fp381::store_pt(out, n, lane,
                    fp381::jac_add(fp381::load_pt(a, n, lane), fp381::load_pt(b, n, lane)));
  } else if constexpr (KIND == kLadd) {
    fp381::store_pt(out, n, lane, fp381::jac_add_ladder(fp381::load_pt(a, n, lane),
                                                        fp381::load_pt(b, n, lane)));
  } else {  // kDblk, kWin
    Pt acc = fp381::load_pt(a, n, lane);
    for (int i = 0; i < k; ++i) acc = fp381::jac_double(acc);
    if constexpr (KIND == kWin) {
      acc = fp381::jac_add_ladder(acc, fp381::load_pt(b, n, lane));
      acc = fp381::jac_add_ladder(acc, fp381::load_pt(c, n, lane));
    }
    fp381::store_pt(out, n, lane, acc);
  }
}

template <int KIND>
cudaError_t launch(const uint32_t* a, const uint32_t* b, const uint32_t* c, uint32_t* out,
                   long long n, int k, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fq_point_kernel<KIND><<<blocks, kThreads, 0, stream>>>(a, b, c, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream` over n lanes; returns cudaGetLastError() (0 on
// success).  kind: 0 mul (a, b: [12, n] -> out [12, n]), 1 dbl (a: [3, 12, n]),
// 2 add, 3 ladd (a, b points), 4 dblk (a, k doublings), 5 win (a the
// accumulator, b and c the two table entries, k doublings), 6 mulc (a: [12, n],
// b: one element, 12 words -> out [12, n]).  Every other operand is contiguous
// with lane stride 1 and word stride n.
extern "C" int fq_point_launch(int device, int kind, int k, const void* a, const void* b,
                               const void* c, void* out, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  const uint32_t* pc = static_cast<const uint32_t*>(c);
  uint32_t* po = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kMul:
      return (int)launch<kMul>(pa, pb, pc, po, n, k, s);
    case kDbl:
      return (int)launch<kDbl>(pa, pb, pc, po, n, k, s);
    case kAdd:
      return (int)launch<kAdd>(pa, pb, pc, po, n, k, s);
    case kLadd:
      return (int)launch<kLadd>(pa, pb, pc, po, n, k, s);
    case kDblk:
      return (int)launch<kDblk>(pa, pb, pc, po, n, k, s);
    case kWin:
      return (int)launch<kWin>(pa, pb, pc, po, n, k, s);
    case kMulC:
      return (int)launch<kMulC>(pa, pb, pc, po, n, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fq_point_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
