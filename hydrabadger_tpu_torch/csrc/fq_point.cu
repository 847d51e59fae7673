// BLS12-381 Fp Montgomery product, Jacobian G1 point ops and whole G1 ladders,
// for Hopper (sm_90a).
//
// Kernel B2.  Replaces hydrabadger_tpu/ops/fq_T.py:_pallas_point_call and its
// bodies: `mul` (_mul_rows; also by one element for every lane), `dbl`
// (_jac_double_body), `add` (the complete _jac_add_body), `ladd` (the
// incomplete _jac_add_ladder_body), `dblk{k}` (k chained doublings) and
// `win{k}` (one GLV window: k doublings and two ladder adds); and adds the
// two ladders of ops/bls_torch in one launch each: `glv_ladder`
// (fq_T.glv_ladder_T: the table of 14 complete adds, its beta-twisted copy,
// then 33 windows of 4 doublings and two complete adds of the entries the
// lane's digits name) and `windowed_ladder` (fq_T.windowed_ladder_T: the
// table, then 64 windows of 4 doublings and one complete add).  Operands and
// results are [.., 12, n] int32 batches laid out lane-fastest (fp381.cuh),
// every output canonical (< p), so each lane equals the JAX body's result
// bit for bit.
//
// What bounds it.  The work is Montgomery products: 1 (mul), 7 (dbl), 16
// (ladd and the add's general formula), 7k (dblk), a decrypt round's ladders
// ~1,000-1,400 per lane; the bytes are the field elements read and written,
// 48 bytes each.  At the card's peaks (a product as int8 tensor-core work,
// ops/roofline.py) bytes bound the single point ops on the decrypt path and
// operations the ladders.  In practice CIOS on the integer ALUs at
// 1408-4096 lanes is bound by the latency of a lane's dependent chain of
// products: a thread that walks a window's 60 products in order, at one warp
// per SMSP, waits on each; and a ladder of one launch per window would add
// its launches and leave its table gathers to torch.
//
// What the design does about that (point_block.cuh).  The point entries run
// a block of 32 lanes x T warps (T = 5, the add's widest layer) over layered
// programs (ops/point_block.py): warp t computes products t, t + T, ... of a
// layer, so a GLV window costs its ~22 layer-steps instead of 60 dependent
// products; wires live in shared-memory slots.  The ladders keep the
// accumulator in the slots for every window, write the tables to a device
// scratch the same block reads back, and gather each window's entries with
// cp.async while the block doubles.  `mul` is one product per lane with no
// layer to split, so it stays one thread per lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "point_block.cuh"

namespace {

using Pts = point_block::Points<1>;

constexpr int kThreads = 128;  // the product entries' block
constexpr int K = Pts::K;      // 3 Fp elements per point
constexpr int kGlvTable = 4;   // a GLV table entry: x, y, z, beta x
constexpr int kWindowDoublings = 4;

enum Kind {
  kMul = 0, kDbl = 1, kAdd = 2, kLadd = 3, kDblk = 4, kWin = 5, kMulC = 6,
  kGlvLadder = 7, kWindowedLadder = 8
};

// mul and mulc: one thread per lane
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    fq_point_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long n) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const fp381::Fp y = KIND == kMulC ? fp381::load(b, 1, 0) : fp381::load(b, n, lane);
  fp381::store(out, n, lane, fp381::mul(fp381::load(a, n, lane), y));
}

// every point entry: a block of 32 lanes x T warps (point_block.cuh)
template <int KIND>
__global__ void __launch_bounds__(32 * point_block::kMaxWarps)
    fq_point_block_kernel(const int* __restrict__ set_g, int set_len,
                          const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                          const uint32_t* __restrict__ c, const int32_t* __restrict__ digits,
                          int windows, uint32_t* table, uint32_t* __restrict__ out,
                          long long n, int k) {
  extern __shared__ uint32_t smem[];
  const Pts pts = point_block::stage<1>(smem, set_g, set_len, n);
  constexpr int kMask = point_block::kTable - 1;
  if constexpr (KIND == kDbl || KIND == kDblk) {
    pts.load(0, a);
    __syncthreads();
    pts.doublings(k);
  } else if constexpr (KIND == kAdd || KIND == kLadd) {
    pts.load(0, a);
    pts.load(K, b);
    __syncthreads();
    pts.add(0, KIND == kAdd);
  } else if constexpr (KIND == kWin) {  // b, c: the two table entries
    pts.load(0, a);
    pts.load(K, b);
    pts.load(2 * K, c);
    __syncthreads();
    pts.doublings(k);
    pts.add(0, false);
    pts.add(1, false);
  } else if constexpr (KIND == kWindowedLadder) {  // digits [windows, n]; table [16, 3, 12, n]
    pts.load(K, a);
    __syncthreads();
    pts.build_table(table, K);
    pts.infinity();
    for (int j = 0; j < windows; ++j) {
      pts.fetch(K, table, K, pts.live ? digits[j * n + pts.g] & kMask : 0, 0);
      pts.doublings(kWindowDoublings);
      __pipeline_wait_prior(0);
      __syncthreads();
      pts.add(0, true);
    }
  } else {  // kGlvLadder: b: beta (one element); digits [2, windows, n]; table [16, 4, 12, n]
    pts.load(K, a);
    __syncthreads();
    pts.build_table(table, kGlvTable);
    // the beta-twisted copy: element 3 of entry i is beta * x_i
    const fp381::Fp beta = fp381::load(b, 1, 0);
    for (int i = pts.b.warp; i < point_block::kTable; i += pts.b.warps) {
      uint32_t* entry = table + (long long)i * kGlvTable * fp381::kWords * n;
      if (pts.live)
        fp381::store(entry + 3LL * fp381::kWords * n, n, pts.g,
                     fp381::mul(fp381::load(entry, n, pts.g), beta));
    }
    __syncthreads();
    pts.infinity();
    for (int j = 0; j < windows; ++j) {
      const int d1 = pts.live ? digits[j * n + pts.g] & kMask : 0;
      const int d2 = pts.live ? digits[(windows + j) * n + pts.g] & kMask : 0;
      pts.fetch(K, table, kGlvTable, d1, 0);      // T1[d1] = (x, y, z)
      pts.fetch(2 * K, table, kGlvTable, d2, 3);  // T2[d2] = (beta x, y, z)
      pts.doublings(kWindowDoublings);
      __pipeline_wait_prior(1);
      __syncthreads();
      pts.add(0, true);
      __pipeline_wait_prior(0);
      __syncthreads();
      pts.add(1, true);
    }
  }
  pts.store(out);
}

template <int KIND>
cudaError_t launch_block(int device, const int* set, int set_len, int smem, int warps,
                         const uint32_t* a, const uint32_t* b, const uint32_t* c,
                         const int32_t* digits, int windows, uint32_t* table, uint32_t* out,
                         long long n, int k, cudaStream_t stream) {
  cudaError_t err = point_block::prepare(fq_point_block_kernel<KIND>, device, smem, warps);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + 31) / 32);
  fq_point_block_kernel<KIND><<<blocks, 32 * warps, smem, stream>>>(
      set, set_len, a, b, c, digits, windows, table, out, n, k);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_mul(int device, const uint32_t* a, const uint32_t* b, uint32_t* out,
                       long long n, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fq_point_kernel<KIND><<<blocks, kThreads, 0, stream>>>(a, b, out, n);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream` over n lanes; returns cudaGetLastError() (0 on
// success).  kind: 0 mul (a, b: [12, n] -> out [12, n]), 6 mulc (a: [12, n],
// b: one element, 12 words -> out [12, n]); the point entries take the
// program set of ops/point_block.py (`set`, set_len int32 on the device),
// `smem` the bytes of shared memory a block takes and `warps` the warps per
// block: 1 dbl (a: [3, 12, n]), 2 add, 3 ladd (a, b points), 4 dblk (a, k
// doublings), 5 win (a the accumulator, b and c the two table entries, k
// doublings), 7 glv_ladder (a the points, b beta as one element, digits
// [2, windows, n] MSB first, table a [16, 4, 12, n] scratch), 8
// windowed_ladder (a the points, digits [windows, n], table a [16, 3, 12, n]
// scratch) -> out [3, 12, n].  Every other operand is contiguous with lane
// stride 1 and word stride n.
extern "C" int fq_point_launch(int device, int kind, int k, const void* set, int set_len,
                               int smem, int warps, const void* a, const void* b, const void* c,
                               const void* digits, int windows, void* table, void* out,
                               long long n, void* stream) {
  if (n <= 0 || k < 0 || windows < 0) return (int)cudaErrorInvalidValue;
  const int* ps = static_cast<const int*>(set);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  const uint32_t* pc = static_cast<const uint32_t*>(c);
  const int32_t* pd = static_cast<const int32_t*>(digits);
  uint32_t* pt = static_cast<uint32_t*>(table);
  uint32_t* po = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kMul) return (int)launch_mul<kMul>(device, pa, pb, po, n, s);
  if (kind == kMulC) return (int)launch_mul<kMulC>(device, pa, pb, po, n, s);
  if (ps == nullptr || set_len < 1) return (int)cudaErrorInvalidValue;
#define HB_LAUNCH(KIND)                                                                    \
  return (int)launch_block<KIND>(device, ps, set_len, smem, warps, pa, pb, pc, pd, windows, \
                                 pt, po, n, k, s)
  switch (kind) {
    case kDbl:
      HB_LAUNCH(kDbl);
    case kAdd:
      if (pb == nullptr) return (int)cudaErrorInvalidValue;
      HB_LAUNCH(kAdd);
    case kLadd:
      if (pb == nullptr) return (int)cudaErrorInvalidValue;
      HB_LAUNCH(kLadd);
    case kDblk:
      HB_LAUNCH(kDblk);
    case kWin:
      if (pb == nullptr || pc == nullptr) return (int)cudaErrorInvalidValue;
      HB_LAUNCH(kWin);
    case kGlvLadder:
      if (pb == nullptr || pd == nullptr || pt == nullptr) return (int)cudaErrorInvalidValue;
      HB_LAUNCH(kGlvLadder);
    case kWindowedLadder:
      if (pd == nullptr || pt == nullptr) return (int)cudaErrorInvalidValue;
      HB_LAUNCH(kWindowedLadder);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HB_LAUNCH
}

extern "C" const char* fq_point_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
