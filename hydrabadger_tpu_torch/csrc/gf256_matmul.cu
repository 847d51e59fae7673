// GF(2^8) matrix product over batched Reed-Solomon shards, for Hopper (sm_90a).
//
// Replaces hydrabadger_tpu/ops/gf256_jax.py:_gf_kernel (launched by
// _gf_matmul_pallas, reached through rs_jax._apply_pallas): the encode and
// reconstruct step of every reliable broadcast.  It computes
//
//     out[b, i, l] = XOR_j  A[i, j] * data[b, j, l]        over GF(2^8)
//
// byte for byte, with data read as [B, k, L] and out written as [B, m, L],
// each through its own strides.  So the encode writes its parity straight
// into rows k.. of the [B, k+p, L] codeword and the reconstruct reads the
// parity-heavy quorum as a view of that codeword: neither needs the two
// transposes nor the lane padding around the TPU kernel.
//
// What bounds it.  At the fast-path epoch's shapes (B*L = 786,432 byte
// columns, A of 42x22 or 22x22) the function moves 34-50 MB, about 10-15 us
// at 3.35 TB/s, while its bit-product form needs 64*m*k int8 multiply-adds
// per column, 25-47 us at the dense int8 tensor-core rate.  This kernel does
// not use the tensor cores: it does the product on the integer ALUs, so the
// logic-op rate is its limit.
//
// What the design does about that.  Multiplication by a constant c is linear
// over GF(2): c*x = XOR_b bit_b(x) * (c * 2^b).  A thread packs four byte
// columns into one 32-bit word, turns bit b of each byte into a 0x00/0xFF
// byte mask, and ANDs it with c*2^b copied into all four bytes, so one
// three-input logic op (LOP3: acc ^= mask & const) does one bit-term of four
// columns at once: 8 ops per matrix entry per 4 columns, no table gathers and
// no bank conflicts.  The constants c*2^b, four bytes wide, come from the
// host (ops/gf256_torch.kernel_consts) as a [m_pad, k, 8] table of words; a
// block stages the rows of its row tile in shared memory and every thread
// reads them with broadcast 16-byte loads.  A thread keeps MT rows times two
// words of sums in registers; the grid's y axis walks the row tiles, so each
// block re-reads its columns of data once per tile (from L2).  Neighbouring
// threads take neighbouring words, and where the layout allows (L % 4 == 0,
// unit column stride, 4-byte aligned base and strides: the epoch's views) a
// word is one 32-bit load or store; otherwise the bytes go one by one.  This
// keeps a warp's stores on few sectors: byte stores 8 columns apart touch ~32
// sectors per 32 bytes and ran 3x slower here (PERF.md).  Ragged edges are
// masked: columns past B*L load zeros and store nothing, rows past m are zero
// in the table and store nothing.
//
// Later work (not here): the int8 bit product on the tensor cores
// (mma.sync / wgmma with int32 sums, then mod 2 and pack), fed by TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 2;  // packed 32-bit words (4 byte columns each) per thread

// byte offset of byte column c (= b*L + l) within row 0 of a [B, rows, L] view
__device__ __forceinline__ long long col_off(long long c, int L, long long sb,
                                             long long sl) {
  const long long b = c / L;
  return b * sb + (c - b * L) * sl;
}

// WORDS: every 4-column word is one aligned 32-bit access (L % 4 == 0, unit
// column stride, 4-byte aligned base and strides); else bytes one by one.
template <int MT, bool WORDS>
__global__ void __launch_bounds__(kThreads)
    gf256_matmul_kernel(const uint32_t* __restrict__ consts,  // [tiles*MT, k, 8]
                        const uint8_t* __restrict__ data, long long d_sb,
                        long long d_sk, long long d_sl, uint8_t* __restrict__ out,
                        long long o_sb, long long o_sm, long long o_sl, int m,
                        int k, int L, long long ncols) {
  constexpr int kOffs = WORDS ? kWords : 4 * kWords;
  extern __shared__ uint4 smem[];  // [MT, k, 2] uint4 = [MT, k, 8] words
  const int tile = blockIdx.y;
  {
    const uint32_t* src = consts + (size_t)tile * MT * k * 8;
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    for (int t = threadIdx.x; t < MT * k * 8; t += kThreads) dst[t] = src[t];
  }
  __syncthreads();

  // Word u of this thread covers byte columns col[u] .. col[u]+3; the
  // threads of a warp take neighbouring words, so their accesses are too.
  long long col[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u)
    col[u] = 4 * (((long long)blockIdx.x * kWords + u) * kThreads + threadIdx.x);
  if (col[0] >= ncols) return;

  long long in_off[kOffs];  // per word (WORDS) or per byte column
#pragma unroll
  for (int t = 0; t < kOffs; ++t) {
    if constexpr (WORDS)
      in_off[t] = col_off(col[t], L, d_sb, d_sl);
    else
      in_off[t] = col_off(col[t / 4] + t % 4, L, d_sb, d_sl);
  }

  uint32_t acc[MT][kWords];
#pragma unroll
  for (int ii = 0; ii < MT; ++ii)
#pragma unroll
    for (int u = 0; u < kWords; ++u) acc[ii][u] = 0u;

  for (int j = 0; j < k; ++j) {
    const long long row = (long long)j * d_sk;
    uint32_t w[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      w[u] = 0u;
      if constexpr (WORDS) {
        if (col[u] < ncols)
          w[u] = *reinterpret_cast<const uint32_t*>(data + in_off[u] + row);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col[u] + q < ncols)
            w[u] |= (uint32_t)data[in_off[4 * u + q] + row] << (8 * q);
      }
    }
    // mask[bit][u]: byte = 0xFF where that bit of the data byte is set
    uint32_t mask[8][kWords];
#pragma unroll
    for (int bit = 0; bit < 8; ++bit)
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        mask[bit][u] = ((w[u] >> bit) & 0x01010101u) * 0xFFu;

#pragma unroll
    for (int ii = 0; ii < MT; ++ii) {
      const uint4 lo = smem[(ii * k + j) * 2];
      const uint4 hi = smem[(ii * k + j) * 2 + 1];
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        acc[ii][u] ^= (mask[0][u] & lo.x) ^ (mask[1][u] & lo.y) ^
                      (mask[2][u] & lo.z) ^ (mask[3][u] & lo.w) ^
                      (mask[4][u] & hi.x) ^ (mask[5][u] & hi.y) ^
                      (mask[6][u] & hi.z) ^ (mask[7][u] & hi.w);
      }
    }
  }

  const int i0 = tile * MT;
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
#pragma unroll
    for (int q = 0; q < (WORDS ? 1 : 4); ++q) {
      if (col[u] + q >= ncols) continue;
      uint8_t* dst = out + col_off(col[u] + q, L, o_sb, o_sl);
#pragma unroll
      for (int ii = 0; ii < MT; ++ii) {
        if (i0 + ii >= m) continue;
        if constexpr (WORDS)
          *reinterpret_cast<uint32_t*>(dst + (long long)(i0 + ii) * o_sm) = acc[ii][u];
        else
          dst[(long long)(i0 + ii) * o_sm] = (uint8_t)(acc[ii][u] >> (8 * q));
      }
    }
  }
}

template <int MT>
cudaError_t launch(const uint32_t* consts, const uint8_t* data, long long d_sb,
                   long long d_sk, long long d_sl, uint8_t* out, long long o_sb,
                   long long o_sm, long long o_sl, int m, int k, int L,
                   long long ncols, cudaStream_t stream) {
  const bool words =
      L % 4 == 0 && d_sl == 1 && o_sl == 1 &&
      ((reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out) |
        (uintptr_t)d_sb | (uintptr_t)d_sk | (uintptr_t)o_sb | (uintptr_t)o_sm) &
       3) == 0;
  auto kernel = words ? gf256_matmul_kernel<MT, true> : gf256_matmul_kernel<MT, false>;
  const size_t smem = (size_t)MT * k * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long per_block = 4LL * kWords * kThreads;
  const dim3 grid((unsigned)((ncols + per_block - 1) / per_block),
                  (unsigned)((m + MT - 1) / MT));
  kernel<<<grid, kThreads, smem, stream>>>(consts, data, d_sb, d_sk, d_sl, out,
                                           o_sb, o_sm, o_sl, m, k, L, ncols);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`; returns cudaGetLastError() (0 on success).
// `consts` is the [ceil(m/tile_m)*tile_m, k, 8] word table; tile_m must be
// one of the row tiles instantiated below (gf256_torch.TILE_M).
extern "C" int gf256_matmul_launch(int device, const void* consts,
                                   const void* data, long long d_sb,
                                   long long d_sk, long long d_sl, void* out,
                                   long long o_sb, long long o_sm,
                                   long long o_sl, int m, int k, int L,
                                   long long B, int tile_m, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || k <= 0 || L <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  const long long ncols = B * (long long)L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 4:
      return (int)launch<4>(c, d, d_sb, d_sk, d_sl, o, o_sb, o_sm, o_sl, m, k, L, ncols, s);
    case 8:
      return (int)launch<8>(c, d, d_sb, d_sk, d_sl, o, o_sb, o_sm, o_sl, m, k, L, ncols, s);
    case 11:
      return (int)launch<11>(c, d, d_sb, d_sk, d_sl, o, o_sb, o_sm, o_sl, m, k, L, ncols, s);
    case 16:
      return (int)launch<16>(c, d, d_sb, d_sk, d_sl, o, o_sb, o_sm, o_sl, m, k, L, ncols, s);
    case 22:
      return (int)launch<22>(c, d, d_sb, d_sk, d_sl, o, o_sb, o_sm, o_sl, m, k, L, ncols, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gf256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
