// Interpreter of a recorded Fp circuit over a batch of lanes, for Hopper (sm_90a).
//
// Replaces hydrabadger_tpu/ops/circuit_T.py:CircuitT._pallas_call (kernel B3,
// body CircuitT._body / _run_mixes): a whole fp12_circuit.Circuit in one
// launch.  The circuit arrives as a flat int32 program (ops/circuit_torch.py
// CircuitExec.program):
//
//     n_inputs, n_const, n_products, n_outputs,
//     (left row, right row) for each product, in wire order,
//     one row for each output;
//     row = n_terms, negsum, (wire, coeff) x n_terms
//
// Wires are numbered inputs, constants, then products.  Every wire is kept
// canonical (< p), and each row's signed small-integer mix is computed exactly
// mod p: V = negsum*p + sum c*x (>= 0 at every step, < 64p), then q =
// floor((V >> 352) / (floor(p / 2^352) + 1)) undershoots floor(V / p) by at most
// one, so V - q*p < 2p and one conditional subtraction makes it canonical.
// (The TPU executor instead keeps wires below 2p and normalises with a
// dominating K*p offset, a Barrett step and a subtraction ladder, because its
// 12-bit limbs need carry passes; the outputs are the same canonical values.)
//
// What bounds it.  The circuits of the decrypt epoch do 58 (dbl^6 + add),
// 44 (dbl^4 + add) and 16 (add) Montgomery products per lane against 576
// (6 elements in, 6 out) or 432 bytes (6 in, 3 out) per lane: at the card's
// peaks operations bound the two dbl^k circuits and bytes the add (PERF.md).
//
// What the design does about that, and where the wires live.  One thread per
// lane walks the program, which every block first copies into shared memory
// (a few KB), so each instruction is a broadcast shared load.  The product
// wires live in a global scratch laid out lane-fastest ([n_products, 12, n],
// 3.3 KB per lane for the dbl^6 circuit): simple, any circuit size, and the
// loads and stores of a warp are coalesced; most reads come soon after the
// write and hit L2.  Shared memory would hold 64 lanes of the largest circuit
// per block (227 KB), too few threads to hide the multiply latency, so it is
// not used for wires.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381.cuh"

namespace {

using fp381::Fp;
using fp381::kP;
using fp381::kWords;

constexpr int kThreads = 128;

struct Wires {
  const uint32_t* in;       // [n_inputs, 12, n]
  const uint32_t* consts;   // [n_const, 12] (broadcast to every lane)
  const uint32_t* scratch;  // [n_products, 12, n], written by this launch
  int n_inputs, n_const;
  long long n, lane;

  __device__ __forceinline__ Fp load(int w) const {
    if (w < n_inputs) return fp381::load(in + (long long)w * kWords * n, n, lane);
    w -= n_inputs;
    if (w < n_const) return fp381::load(consts + w * kWords, 1, 0);
    return fp381::load(scratch + (long long)(w - n_const) * kWords * n, n, lane);
  }
};

// acc[0..12] += c * x
__device__ __forceinline__ void mac(uint32_t* acc, const Fp& x, uint32_t c) {
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t s = (uint64_t)x.w[i] * c + acc[i] + carry;
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

// one program row at prog[pc..]; advances pc past it
__device__ __forceinline__ Fp eval_row(const int* prog, int& pc, const Wires& wires) {
  const int n_terms = prog[pc];
  const int negsum = prog[pc + 1];
  const int* terms = prog + pc + 2;
  pc += 2 + 2 * n_terms;
  if (n_terms == 0) return fp381::zero();
  if (n_terms == 1 && terms[1] == 1) return wires.load(terms[0]);
  if (n_terms == 1 && terms[1] == -1) return fp381::sub(fp381::zero(), wires.load(terms[0]));
  Fp p;
  uint32_t acc[kWords + 1];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    p.w[i] = kP[i];
    acc[i] = 0u;
  }
  acc[kWords] = 0u;
  mac(acc, p, (uint32_t)negsum);  // V starts at negsum * p
  for (int t = 0; t < n_terms; ++t) {
    const Fp x = wires.load(terms[2 * t]);
    const int c = terms[2 * t + 1];
    if (c > 0)
      mac(acc, x, (uint32_t)c);
    else
      msub(acc, x.w, (uint32_t)(-c));
  }
  // V < 64p < 2^388: q from V >> 352 undershoots floor(V/p) by at most one
  const uint64_t top = ((uint64_t)acc[kWords] << 32) | acc[kWords - 1];
  const uint32_t q = (uint32_t)(top / ((uint64_t)p.w[kWords - 1] + 1u));
  msub(acc, p.w, q);
  Fp r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = acc[i];  // acc < 2p: acc[12] == 0
  return fp381::reduce_once(r);
}

__global__ void __launch_bounds__(kThreads)
    circuit_kernel(const int* __restrict__ prog_g, int prog_len,
                   const uint32_t* __restrict__ in, const uint32_t* __restrict__ consts,
                   uint32_t* scratch, uint32_t* __restrict__ out, long long n) {
  extern __shared__ int prog[];
  for (int i = threadIdx.x; i < prog_len; i += kThreads) prog[i] = prog_g[i];
  __syncthreads();
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const Wires wires{in, consts, scratch, prog[0], prog[1], n, lane};
  const int n_products = prog[2];
  const int n_outputs = prog[3];
  int pc = 4;
  for (int p = 0; p < n_products; ++p) {
    const Fp l = eval_row(prog, pc, wires);
    const Fp r = eval_row(prog, pc, wires);
    fp381::store(scratch + (long long)p * kWords * n, n, lane, fp381::mul(l, r));
  }
  for (int o = 0; o < n_outputs; ++o)
    fp381::store(out + (long long)o * kWords * n, n, lane, eval_row(prog, pc, wires));
}

}  // namespace

// One launch on `stream` over n lanes; returns cudaGetLastError() (0 on
// success).  `prog` (prog_len int32 on the device) is the program above, `in`
// the [n_inputs, 12, n] inputs, `consts` the [n_const, 12] constants (may be
// null without constants), `scratch` room for [n_products, 12, n], `out` the
// [n_outputs, 12, n] result.
extern "C" int circuit_launch(int device, const void* prog, int prog_len, const void* in,
                              const void* consts, void* scratch, void* out, long long n,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || prog_len < 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)prog_len * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(circuit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  circuit_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prog), prog_len, static_cast<const uint32_t*>(in),
      static_cast<const uint32_t*>(consts), static_cast<uint32_t*>(scratch),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* circuit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
