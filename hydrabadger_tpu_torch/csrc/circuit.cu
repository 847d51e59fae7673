// Interpreter of a recorded Fp circuit over a batch of lanes, for Hopper (sm_90a).
//
// Replaces hydrabadger_tpu/ops/circuit_T.py:CircuitT._pallas_call (kernel B3,
// body CircuitT._body / _run_mixes): a whole fp12_circuit.Circuit in one
// launch, and, as the chain entry, a static schedule of such circuits over one
// accumulator (the decrypt epoch's Straus combine: decrypt_T's lax.scan).
//
// The program (ops/circuit_torch.py slot_program), int32 words; every pc
// below is an offset from the program's first word:
//
//     header      n_inputs, n_layers, n_outputs, n_products
//     layer_start [n_layers + 1]   first product of each layer, then n_products
//     prod_pc     [n_products]     pc of each product's record
//     out_pc      [n_outputs]      pc of each output's record
//     product     dest slot, left row, right row
//     output      out slot (written by a chain step only), row
//     row         n_terms, negsum, (ref, coeff) x n_terms
//
// A ref >= 0 names a slot, a ref < 0 the constant -1 - ref.  Inputs are slots
// 0 .. n_inputs-1.  A slot is reused only by a later layer than the last that
// reads its wire, so the products of a layer never overwrite what another warp
// of that layer reads.  The chain's buffer is [n_circuits, offset of each
// program, the programs]; a step is (circuit or -1, table entry, take): the
// circuit runs on (acc, entry), and acc becomes its output group `take`
// (outputs take*n_acc ..), or, with no circuit, the entry itself.
//
// Shared memory holds the program padded to 16 bytes, the n_const constants
// [n_const][12], then the slots; the caller sizes it (ops/circuit_torch.py
// smem_bytes) and passes the bytes to the launch.
//
// Every wire is kept canonical (< p), and each row's signed small-integer mix
// is computed exactly mod p: V = negsum*p + sum c*x (>= 0 at every step,
// < 64p), then q = floor((V >> 352) / (floor(p / 2^352) + 1)) undershoots
// floor(V / p) by at most one, so V - q*p < 2p and one conditional subtraction
// makes it canonical.  The divisor is the compile-time constant 0x1a0111eb, so
// the division is a multiply.  (The TPU executor instead keeps wires below 2p
// and normalises with a dominating K*p offset, a Barrett step and a
// subtraction ladder, because its 12-bit limbs need carry passes; the outputs
// are the same canonical values.)
//
// What bounds it.  The decrypt circuits do 58 (dbl^6 + add), 44 (dbl^4 + add)
// and 16 (add) Montgomery products per lane; at the card's peaks operations
// bound the two dbl^k circuits and the chain, and bytes a lone add (PERF.md).
// What held the one-thread-per-lane interpreter back was neither: at 4096
// lanes one warp per SMSP of 32 SMs walked every product of a lane in order
// (the latency of a dependent chain of CIOS products), wires went through a
// global scratch, and the Straus combine was 747 launches.
//
// What the design does about that.  A block is 32 lanes x T warps (T from the
// circuit's layer widths): warp t computes products t, t + T, ... of each
// layer for its 32 lanes, every thread of a warp runs the same rows (no
// divergence; the program is a broadcast read from shared memory), and a
// block barrier separates the layers, so a lane's dependent chain is its
// layers, not its products, and 4096 lanes fill 128 SMs.  The wires live in
// shared-memory slots laid out [slot][word][32 lanes] (a warp's access is one
// word per bank); inputs are read from device memory once and outputs written
// once.  Lanes past n compute on zeros and store nothing (no early return
// before a barrier).  The chain keeps its accumulator in the slots from step
// to step and reads only each step's table entry: warp e fetches element e of
// the next step's entry into registers while a step runs (the caller gives a
// chain at least as many warps as an entry has elements).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381.cuh"

namespace {

using fp381::Fp;
using fp381::kP;
using fp381::kWords;

constexpr int kMaxWarps = 8;
constexpr int kHeader = 4;
constexpr int kSlotWords = kWords * 32;  // one slot: 12 words x 32 lanes
constexpr uint64_t kPTopPlus1 = 0x1a0111ebull;  // floor(p / 2^352) + 1

struct Block {
  uint32_t* slots;         // [n_slots][12][32]
  const uint32_t* consts;  // [n_const][12], broadcast to every lane
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
  __device__ __forceinline__ Fp ref(int r) const {
    if (r >= 0) return slot(r);
    Fp a;
    const uint32_t* c = consts + (-1 - r) * kWords;
#pragma unroll
    for (int i = 0; i < kWords; ++i) a.w[i] = c[i];
    return a;
  }
  // elements 0 .. count-1 of a [count, 12, n] array into slots 0 ..,
  // spread over the warps; lanes past n take zeros
  __device__ __forceinline__ void load(int count, const uint32_t* src, long long n,
                                       long long g, bool live) const {
    for (int e = warp; e < count; e += warps)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        slots[e * kSlotWords + i * 32 + lane] = live ? src[(e * kWords + i) * n + g] : 0u;
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

// the row at prog[pc..]
__device__ __forceinline__ Fp eval_row(const int* prog, int pc, const Block& b) {
  const int n_terms = prog[pc];
  const int negsum = prog[pc + 1];
  const int* terms = prog + pc + 2;
  if (n_terms == 0) return fp381::zero();
  if (n_terms == 1 && terms[1] == 1) return b.ref(terms[0]);
  if (n_terms == 1 && terms[1] == -1) return fp381::sub(fp381::zero(), b.ref(terms[0]));
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
    const Fp x = b.ref(terms[2 * t]);
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

// the product record at pc: dest slot, then its two rows
__device__ __forceinline__ void product(const int* prog, int pc, const Block& b) {
  const int dest = prog[pc];
  pc += 1;
  const Fp l = eval_row(prog, pc, b);
  pc += 2 + 2 * prog[pc];
  const Fp r = eval_row(prog, pc, b);
  b.put(dest, fp381::mul(l, r));
}

// every layer of the program, a barrier after each
__device__ __forceinline__ void run_layers(const int* prog, const Block& b) {
  const int n_layers = prog[1];
  const int* layer_start = prog + kHeader;
  const int* prod_pc = layer_start + n_layers + 1;
  for (int layer = 0; layer < n_layers; ++layer) {
    for (int j = layer_start[layer] + b.warp; j < layer_start[layer + 1]; j += b.warps)
      product(prog, prod_pc[j], b);
    __syncthreads();
  }
}

__device__ __forceinline__ const int* out_pcs(const int* prog) {
  return prog + kHeader + prog[1] + 1 + prog[3];
}

// the block's shared memory: the program(s), the constants, the slots
__device__ __forceinline__ Block stage(uint32_t* smem, const int* prog_g, int prog_len,
                                       const uint32_t* consts_g, int n_const) {
  const int threads = blockDim.x;
  const int prog_pad = (prog_len + 3) & ~3;
  for (int i = threadIdx.x; i < prog_len; i += threads) smem[i] = (uint32_t)prog_g[i];
  uint32_t* consts = smem + prog_pad;
  for (int i = threadIdx.x; i < n_const * kWords; i += threads) consts[i] = consts_g[i];
  return Block{consts + n_const * kWords, consts, (int)(threadIdx.x & 31),
               (int)(threadIdx.x >> 5), threads >> 5};
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    circuit_kernel(const int* __restrict__ prog_g, int prog_len,
                   const uint32_t* __restrict__ in, const uint32_t* __restrict__ consts_g,
                   int n_const, uint32_t* __restrict__ out, long long n) {
  extern __shared__ uint32_t smem[];
  const Block b = stage(smem, prog_g, prog_len, consts_g, n_const);
  const int* prog = reinterpret_cast<const int*>(smem);
  const long long g = (long long)blockIdx.x * 32 + b.lane;
  const bool live = g < n;
  __syncthreads();  // the program is in place
  b.load(prog[0], in, n, g, live);
  __syncthreads();
  run_layers(prog, b);
  const int n_outputs = prog[2];
  const int* out_pc = out_pcs(prog);
  for (int o = b.warp; o < n_outputs; o += b.warps) {
    const Fp v = eval_row(prog, out_pc[o] + 1, b);
    if (live) fp381::store(out + (long long)o * kWords * n, n, g, v);
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    circuit_chain_kernel(const int* __restrict__ progs_g, int progs_len,
                         const int* __restrict__ steps, int n_steps,
                         const uint32_t* __restrict__ table, long long n_entries,
                         const uint32_t* __restrict__ acc_in,
                         const uint32_t* __restrict__ consts_g, int n_const,
                         uint32_t* __restrict__ acc_out, long long n, int n_acc) {
  extern __shared__ uint32_t smem[];
  const Block b = stage(smem, progs_g, progs_len, consts_g, n_const);
  const int* progs = reinterpret_cast<const int*>(smem);
  const long long g = (long long)blockIdx.x * 32 + b.lane;
  const bool live = g < n;
  const long long e_stride = kWords * n_entries * n, w_stride = n_entries * n;
  __syncthreads();  // the programs are in place
  b.load(n_acc, acc_in, n, g, live);
  // Each step's entry (n_sel <= warps elements) goes to slots n_acc ..
  // beside the accumulator, or over it for a step without a circuit.  Warp e
  // fetches element e of the next step's entry into registers while this
  // step runs, so the device-memory latency is off the chain's critical path.
  const int n_sel = progs[progs[1]] - n_acc;
  uint32_t next[kWords];
  auto fetch = [&](int s) {
    if (b.warp >= n_sel) return;
    const uint32_t* src = table + (long long)steps[3 * s + 1] * n + b.warp * e_stride + g;
#pragma unroll
    for (int i = 0; i < kWords; ++i) next[i] = live ? src[i * w_stride] : 0u;
  };
  if (n_steps > 0) fetch(0);
  for (int s = 0; s < n_steps; ++s) {
    const int c = steps[3 * s];
    const int first = c < 0 ? 0 : n_acc;
    if (b.warp < n_sel)
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        b.slots[(first + b.warp) * kSlotWords + i * 32 + b.lane] = next[i];
    if (s + 1 < n_steps) fetch(s + 1);
    __syncthreads();
    if (c < 0) continue;  // the accumulator became the entry
    const int* prog = progs + progs[1 + c];
    run_layers(prog, b);
    // output group `take` into its output slots (never read by the output
    // rows, never an input slot), then into the accumulator's slots
    const int* out_pc = out_pcs(prog) + steps[3 * s + 2] * n_acc;
    for (int k = b.warp; k < n_acc; k += b.warps)
      b.put(prog[out_pc[k]], eval_row(prog, out_pc[k] + 1, b));
    __syncthreads();
    for (int k = b.warp; k < n_acc; k += b.warps) b.put(k, b.slot(prog[out_pc[k]]));
    __syncthreads();
  }
  for (int k = b.warp; k < n_acc; k += b.warps)
    if (live) fp381::store(acc_out + (long long)k * kWords * n, n, g, b.slot(k));
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

}  // namespace

// One launch of a circuit on `stream` over n lanes; returns cudaGetLastError()
// (0 on success).  `prog` (prog_len int32 on the device) is the program above,
// `smem` the bytes of shared memory a block takes, `warps` the warps per
// block, `in` the [n_inputs, 12, n] inputs, `consts` the [n_const, 12]
// constants (may be null without constants), `out` the [n_outputs, 12, n]
// result.
extern "C" int circuit_launch(int device, const void* prog, int prog_len, int smem, int warps,
                              const void* in, const void* consts, int n_const, void* out,
                              long long n, void* stream) {
  if (n <= 0 || prog_len < kHeader) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(circuit_kernel, device, smem, warps);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + 31) / 32);
  circuit_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prog), prog_len, static_cast<const uint32_t*>(in),
      static_cast<const uint32_t*>(consts), n_const, static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

// One launch of a chain on `stream` over n lanes.  `progs` (progs_len int32)
// is the chain's program buffer, `smem` the bytes of shared memory a block
// takes (for the most slots a step uses), `warps` the warps per block (at
// least an entry's elements), `steps` n_steps (circuit, entry, take) triples,
// `table` the [n_inputs - n_acc, 12, n_entries, n] entries, `acc_in` and
// `acc_out` [n_acc, 12, n], `consts` the [n_const, 12] constants of all the
// programs (may be null without constants).
extern "C" int circuit_chain_launch(int device, const void* progs, int progs_len, int smem,
                                    int warps, const void* steps, int n_steps, const void* table,
                                    long long n_entries, const void* acc_in, const void* consts,
                                    int n_const, void* acc_out, long long n, int n_acc,
                                    void* stream) {
  if (n <= 0 || progs_len < 1 + kHeader || n_acc <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(circuit_chain_kernel, device, smem, warps);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + 31) / 32);
  circuit_chain_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(progs), progs_len, static_cast<const int*>(steps), n_steps,
      static_cast<const uint32_t*>(table), n_entries, static_cast<const uint32_t*>(acc_in),
      static_cast<const uint32_t*>(consts), n_const, static_cast<uint32_t*>(acc_out), n, n_acc);
  return (int)cudaGetLastError();
}

extern "C" const char* circuit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
