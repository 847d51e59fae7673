// Layer-parallel Jacobian point formulas for a block of 32 lanes x T warps.
//
// Shared by fq_point.cu (kernel B2, G1) and fq2_point.cu (kernel B4, G2).
// Each point formula is a recorded Fp circuit compiled host-side into the
// slotted program of circuit.cu (ops/point_block.py builds the set, the
// format is documented at the top of circuit.cu; the slot helpers below are
// copies of circuit.cu's, without its constants, which no point formula
// has).  Warp t computes products t, t + T, ... of each layer for its 32
// lanes; a block barrier separates the layers; wires live in shared-memory
// slots [slot][12 words][32 lanes].
//
// The slots, below every program's own: the accumulator in 0 .. K-1 (K = 3C
// field elements, C = 1 for G1, 2 for G2), operand region t in
// K (1 + t) .. K (2 + t) - 1.  Every program keeps its inputs, so it writes
// only above them: `dbl` and `dblk4` double the accumulator into their output
// slots, `add{t}` computes the add's general formula of acc + operand t
// (outputs x3, y3, z3, h, r), and `arm` (the doubling arm) doubles the
// accumulator above every slot an add's outputs use.  The complete add picks
// per lane, in fq_T._jac_add_body's order: acc at infinity -> the operand,
// operand at infinity -> acc, h = r = 0 -> the arm, else the general result;
// the arm runs only when some lane of the block needs it.  The double never
// short-circuits infinity: X and Y stay as the formula leaves them.
//
// Operands named by a per-lane digit are fetched with cp.async into their
// region while the block doubles, so the gather's latency is off the chain.
// Lanes past n compute on zeros and store nothing; no thread returns before
// a barrier.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381.cuh"

namespace point_block {

using fp381::Fp;
using fp381::kP;
using fp381::kWords;

constexpr int kMaxWarps = 8;
constexpr int kHeader = 4;
constexpr int kSlotWords = kWords * 32;  // one slot: 12 words x 32 lanes
constexpr uint64_t kPTopPlus1 = 0x1a0111ebull;  // floor(p / 2^352) + 1
constexpr int kTable = 16;                     // w = 4 window tables

// the set's programs, in the order of its offset table (ops/point_block.py)
enum Prog { kProgDbl = 0, kProgDblk4 = 1, kProgArm = 2, kProgAdd = 3 };

// Jacobian infinity as the JAX package writes it: x = y = one, z = 0 (one =
// R mod p, the Montgomery one; over Fp2 the c1 halves are 0)
__constant__ uint32_t kOne[kWords] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct Block {
  uint32_t* slots;  // [n_slots][12][32]
  int lane, warp, warps;

  __device__ __forceinline__ Fp slot(int s) const {
    Fp a;
#pragma unroll
    for (int i = 0; i < kWords; ++i) a.w[i] = slots[s * kSlotWords + i * 32 + lane];
    return a;
  }
  __device__ __forceinline__ void put(int s, const Fp& a) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) slots[s * kSlotWords + i * 32 + lane] = a.w[i];
  }
};

// acc[0..12] += c * x
__device__ __forceinline__ void mac(uint32_t* acc, const uint32_t* x, uint32_t c) {
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t s = (uint64_t)x[i] * c + acc[i] + carry;
    acc[i] = (uint32_t)s;
    carry = s >> 32;
  }
  acc[kWords] += (uint32_t)carry;
}

// acc[0..12] -= c * x (the caller keeps acc >= c * x)
__device__ __forceinline__ void msub(uint32_t* acc, const uint32_t* x, uint32_t c) {
  uint32_t hi = 0u, borrow = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t prod = (uint64_t)x[i] * c + hi;
    hi = (uint32_t)(prod >> 32);
    const uint64_t s = (uint64_t)acc[i] - (uint32_t)prod - borrow;
    acc[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  acc[kWords] = acc[kWords] - hi - borrow;
}

// the row at prog[pc..], exactly mod p and canonical (circuit.cu's eval_row;
// every ref is a slot)
__device__ __forceinline__ Fp eval_row(const int* prog, int pc, const Block& b) {
  const int n_terms = prog[pc];
  const int negsum = prog[pc + 1];
  const int* terms = prog + pc + 2;
  if (n_terms == 0) return fp381::zero();
  if (n_terms == 1 && terms[1] == 1) return b.slot(terms[0]);
  if (n_terms == 1 && terms[1] == -1) return fp381::sub(fp381::zero(), b.slot(terms[0]));
  uint32_t p[kWords];
  uint32_t acc[kWords + 1];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    p[i] = kP[i];
    acc[i] = 0u;
  }
  acc[kWords] = 0u;
  mac(acc, p, (uint32_t)negsum);  // V starts at negsum * p
  for (int t = 0; t < n_terms; ++t) {
    const Fp x = b.slot(terms[2 * t]);
    const int c = terms[2 * t + 1];
    if (c > 0)
      mac(acc, x.w, (uint32_t)c);
    else
      msub(acc, x.w, (uint32_t)(-c));
  }
  // V < 64p < 2^388: q from V >> 352 undershoots floor(V/p) by at most one
  const uint64_t top = ((uint64_t)acc[kWords] << 32) | acc[kWords - 1];
  msub(acc, p, (uint32_t)(top / kPTopPlus1));
  Fp r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = acc[i];  // acc < 2p: acc[12] == 0
  return fp381::reduce_once(r);
}

__device__ __forceinline__ const int* out_pcs(const int* prog) {
  return prog + kHeader + prog[1] + 1 + prog[3];
}

// every layer of the program, a barrier after each, then its outputs into
// their output slots (never read by the output rows) and a barrier
__device__ __forceinline__ void run(const int* prog, const Block& b) {
  const int n_layers = prog[1];
  const int* layer_start = prog + kHeader;
  const int* prod_pc = layer_start + n_layers + 1;
  for (int layer = 0; layer < n_layers; ++layer) {
    for (int j = layer_start[layer] + b.warp; j < layer_start[layer + 1]; j += b.warps) {
      int pc = prod_pc[j];
      const int dest = prog[pc];
      pc += 1;
      const Fp l = eval_row(prog, pc, b);
      pc += 2 + 2 * prog[pc];
      const Fp r = eval_row(prog, pc, b);
      b.put(dest, fp381::mul(l, r));
    }
    __syncthreads();
  }
  const int* out_pc = out_pcs(prog);
  for (int o = b.warp; o < prog[2]; o += b.warps)
    b.put(prog[out_pc[o]], eval_row(prog, out_pc[o] + 1, b));
  __syncthreads();
}

// output o's slot
__device__ __forceinline__ int out_slot(const int* prog, int o) { return prog[out_pcs(prog)[o]]; }

// The block's state for points of C Fp elements per coordinate.  A point
// batch in device memory is [K, 12, n] lane-fastest; a table is
// [16, kt, 12, n] (entry-major), kt >= K elements per entry.
template <int C>
struct Points {
  static constexpr int K = 3 * C;
  Block b;
  const int* set;  // the program set, in shared memory
  long long n, g;  // lanes, this thread's lane
  bool live;       // g < n

  __device__ __forceinline__ const int* prog(int i) const { return set + set[1 + i]; }

  // slots first .. first+K-1 <- the point at src ([K, 12, n]); zeros past n
  __device__ __forceinline__ void load(int first, const uint32_t* src) const {
    for (int e = b.warp; e < K; e += b.warps)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        b.slots[(first + e) * kSlotWords + i * 32 + b.lane] =
            live ? src[((long long)e * kWords + i) * n + g] : 0u;
  }

  // Issue (cp.async) the copy of table entry `digit` (element map: element 0
  // from element `x_elem`, the others from themselves) into region `first`,
  // then commit one batch (every thread commits, so batches stay in step).
  __device__ __forceinline__ void fetch(int first, const uint32_t* table, int kt, int digit,
                                        int x_elem) const {
    for (int e = b.warp; e < K; e += b.warps) {
      uint32_t* dst = b.slots + (first + e) * kSlotWords + b.lane;
      if (live) {
        const uint32_t* src =
            table + ((long long)(digit * kt + (e == 0 ? x_elem : e)) * kWords) * n + g;
#pragma unroll
        for (int i = 0; i < kWords; ++i) __pipeline_memcpy_async(dst + i * 32, src + i * n, 4);
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) dst[i * 32] = 0u;
      }
    }
    __pipeline_commit();
  }

  // the accumulator to device memory ([K, 12, n]), live lanes only
  __device__ __forceinline__ void store(uint32_t* dst) const {
    for (int e = b.warp; e < K; e += b.warps) {
      const Fp v = b.slot(e);
      if (live) fp381::store(dst + (long long)e * kWords * n, n, g, v);
    }
  }

  // the accumulator <- infinity
  __device__ __forceinline__ void infinity() const {
    for (int e = b.warp; e < K; e += b.warps) {
      const bool one = e % C == 0 && e < 2 * C;  // x.c0, y.c0
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        b.slots[e * kSlotWords + i * 32 + b.lane] = one ? kOne[i] : 0u;
    }
    __syncthreads();
  }

  // the accumulator <- its `k` chained doublings
  __device__ __forceinline__ void doublings(int k) const {
    for (; k > 0; k -= k >= 4 ? 4 : 1) {
      const int* p = prog(k >= 4 ? kProgDblk4 : kProgDbl);
      run(p, b);
      for (int e = b.warp; e < K; e += b.warps) b.put(e, b.slot(out_slot(p, e)));
      __syncthreads();
    }
  }

  __device__ __forceinline__ bool zero_at(int first) const {
    bool z = true;
#pragma unroll
    for (int i = 0; i < C; ++i) z = z && fp381::is_zero(b.slot(first + i));
    return z;
  }

  // the accumulator <- acc + operand region t: the complete add (with the
  // doubling arm) or the ladder's incomplete add (infinity selects only)
  __device__ __forceinline__ void add(int t, bool complete) const {
    const int* p = prog(kProgAdd + t);
    const int op = K * (1 + t);
    run(p, b);
    const bool inf1 = zero_at(2 * C), inf2 = zero_at(op + 2 * C);
    bool hr0 = true;  // h and r: outputs K .. K + 2C - 1
    for (int i = 0; i < 2 * C; ++i) hr0 = hr0 && fp381::is_zero(b.slot(out_slot(p, K + i)));
    const bool dbl = complete && hr0 && !inf1 && !inf2;
    const int* arm = prog(kProgArm);
    // a barrier: every thread has read its flags before any slot below changes
    if (__syncthreads_or(dbl)) run(arm, b);
    for (int e = b.warp; e < K; e += b.warps) {
      const int src = inf1 ? op + e : inf2 ? e : dbl ? out_slot(arm, e) : out_slot(p, e);
      if (src != e) b.put(e, b.slot(src));
    }
    __syncthreads();
  }

  // Build the w = 4 table of the point in operand region 0 into `table`
  // ([16, kt, 12, n]): entry 0 infinity, 1 the point, i + 1 = entry i + P by
  // the complete add (entry 2 through the doubling arm).  Leaves the
  // accumulator at 15 P; ends with a barrier (the entries are visible to
  // the block).
  __device__ __forceinline__ void build_table(uint32_t* table, int kt) const {
    const long long entry = (long long)kt * kWords * n;
    for (int e = b.warp; e < K; e += b.warps) {
      const Fp v = b.slot(K + e);
      const bool one = e % C == 0 && e < 2 * C;
      b.put(e, v);
      if (live) {
        Fp inf;
#pragma unroll
        for (int i = 0; i < kWords; ++i) inf.w[i] = one ? kOne[i] : 0u;
        fp381::store(table + (long long)e * kWords * n, n, g, inf);
        fp381::store(table + entry + (long long)e * kWords * n, n, g, v);
      }
    }
    __syncthreads();
    for (int i = 2; i < kTable; ++i) {
      add(0, true);
      store(table + i * entry);
    }
    __syncthreads();
  }
};

// The block's view of its slots; the caller sizes the dynamic shared memory
// (ops/point_block.py: the set padded to 16 bytes, then the slots).
template <int C>
__device__ __forceinline__ Points<C> stage(uint32_t* smem, const int* set_g, int set_len,
                                           long long n) {
  for (int i = threadIdx.x; i < set_len; i += blockDim.x) smem[i] = (uint32_t)set_g[i];
  Points<C> pts;
  pts.b = Block{smem + ((set_len + 3) & ~3), (int)(threadIdx.x & 31), (int)(threadIdx.x >> 5),
                (int)(blockDim.x >> 5)};
  pts.set = reinterpret_cast<const int*>(smem);
  pts.n = n;
  pts.g = (long long)blockIdx.x * 32 + pts.b.lane;
  pts.live = pts.g < n;
  __syncthreads();  // the set is in place
  return pts;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, int smem, int warps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (warps < 1 || warps > kMaxWarps || smem <= 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

}  // namespace point_block
