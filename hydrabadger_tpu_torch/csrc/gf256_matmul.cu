// GF(2^8) matrix product over batched Reed-Solomon shards, for Hopper (sm_90a),
// on the int8 tensor cores.
//
// Replaces hydrabadger_tpu/ops/gf256_jax.py:148 _gf_kernel (launched by
// _gf_matmul_pallas, reached through rs_jax._apply_pallas): the encode and
// reconstruct step of every reliable broadcast.  It computes
//
//     out[b, i, l] = XOR_j  A[i, j] * data[b, j, l]        over GF(2^8)
//
// byte for byte, with data read as [B, k, L] and out written as [B, m, L],
// each through its own strides.  So the encode writes its parity straight
// into rows k.. of the [B, k+p, L] codeword and the reconstruct reads the
// parity-heavy quorum as a view of that codeword.
//
// The bit product.  Multiplication by a constant is linear over GF(2), so A
// lifts to an [8m, 8k] 0/1 matrix (row i*8 + bit, column j*8 + jbit, LSB
// first, as crypto/gf256.expand_to_bit_matrix) and the product is
//
//     bits(out col) = (Abits @ bits(data col)) mod 2,
//
// an int8 matrix product with int32 sums of at most 8k <= 2032: exact.  Like
// the TPU kernel, this one runs it on the matrix units; unlike it, the bits
// of the data never leave registers and the pack costs no second product.
//
// What bounds it.  At the fast-path epoch's shapes (B*L = 786,432 byte
// columns, A of 42x22 for the encode and 22x22 for the reconstruct) the
// bit product is 2*(8m)*(8k) int8 operations per column: 93.0 G and 48.7 G,
// 0.0470 ms and 0.0246 ms at the dense int8 rate (1,979 TOP/s), while the
// bytes (data and out once, 50.3 MB and 34.6 MB) take 0.0150 ms and 0.0103
// ms at 3.35 TB/s.  So the tensor-core rate bounds it; the integer units,
// on which the earlier SWAR form of this kernel spent ~2,200 logic ops per
// column, only feed them.
//
// What the design does about that.
//  - The data on the M side, A's bits on the N side, K = 32 bits = 4 data
//    bytes, m and k padded to multiples of 4 bytes (the MMA work is 264 /
//    144 m16n8k32 tiles per 16 columns, 14% / 19% above the bound's count).
//    The form the wrapper launches (FORM 1) is wgmma m64n32k32 per
//    warpgroup: each warp holds the A fragments of MT M tiles of 16 columns
//    for every K tile in registers, and one pass issues the MT x KT
//    instructions of 4 output bytes, waits, and packs.  FORM 0
//    (mma.sync.m16n8k32 per warp) and FORM 2 (passes of N = 64) stay for
//    experiments/prof_gf_tiles.py, which measured FORM 1 fastest on an H100
//    SXM at 700 W; there mma.sync reaches ~35% of the int8 peak on these
//    shapes, and wgmma streaming passes without packing ~55%.
//  - A's bits are built once per matrix on the host (ops/gf256_torch
//    .b_operand), zero-padded to whole tiles, in wgmma's K-major layout
//    without swizzle (a 128-byte swizzle measured 1.5-4.6% faster, not
//    worth a second layout).  A persistent grid (blocks per SM x SMs) walks
//    the column tiles, so a block copies them into shared memory once (by
//    cp.async).  Shapes whose bits exceed a block's share are split by the
//    wrapper into launches over row chunks of A (and, past 256 data rows,
//    over K chunks that XOR into `out`).
//  - The data streams through a ring of STAGES shared-memory tiles of
//    [kp rows][C columns] bytes.  Each lane expands the bytes it needs
//    straight into its A fragment: 4 bits of one byte become 4 int8 lanes
//    with one byte permute, one multiply and one mask.  No bit tensor is
//    written.
//  - Three layouts of a tile (LAYOUT; ops/gf256_torch.launch_path picks
//    one from the view's length, strides and pointers):
//      WORDS: C consecutive byte columns c = b*L + l, moved as 4-byte
//        cp.async words and 32-bit stores; the view must allow it (L % 4 ==
//        0, unit column strides, 4-byte aligned pointers and strides).
//      ROWS: C columns of one shard row b, so B * ceil(L / C) tiles, one
//        division per tile.  Each data row's run (any alignment) is fetched
//        as the 16-byte cp.async words that cover it, with its byte shift
//        (address & 15) kept: a lane realigns its bytes with one permute
//        per 4 as it expands them.  The epilogue stores the WORDS way into
//        the tile's m output rows staged in shared memory; after the last
//        pass, one barrier, and each output row's run leaves as aligned
//        16-byte words, shifted into place from the stage, with masked
//        32-bit atomics only in the words it shares with the next run.
//        (Stitching the stores in registers instead, by shuffles and byte
//        stores at each warp's ends, measured 14% slower on rs64-batch64k's
//        encode and 10% on its reconstruct.)  The
//        last tile of a row computes columns past L from whatever the
//        covering words hold, and stores none of them.
//      BYTES: any view, one byte at a time, each column's offset by one
//        division; kept for rows shorter than a tile (the low-comm
//        sketches' 1-16 columns), where ROWS would compute mostly padding.
//  - The mod-2-and-pack epilogue.  N tile nt = 4G + q, column n maps to
//    output byte 4G + n/2, bit 2q + n%2, and that column of B is scaled by
//    2^bit (bit 7 by -128, which is 128 mod 256).  So the int32 sum already
//    holds its parity at the output bit's own position with zeros below,
//    and after 4 N tiles a lane holds all 8 bits of one output byte for its
//    2*MT columns: one LOP3 per sum, (sum & 2^bit) | byte.  The lane's
//    columns are consecutive, so 4 bytes pack with 3 byte permutes into
//    one 32-bit store; no shuffle.  Per pass (4 output bytes) a lane issues
//    16*MT LOP3 + 3*MT/2 PRMT + MT/2 stores against MT*KT wgmma of its
//    warpgroup (MT = 4, KT = 6: 64 + 6 + 2 against 24).  Removing it
//    entirely saves ~10% of the kernel's time.
//  - Sums are packed only after the pass's wait: ptxas serializes every
//    wgmma of a warpgroup that reads one set of sums while another set is
//    in flight (C7514), which made a two-set pipeline 1.8x slower, so the
//    overlap of packing and products comes from the other warpgroups of
//    the SM.
//  - Ragged edges: columns past B*L load zeros and store nothing; rows past
//    m are zero in the operand and store nothing; every thread reaches
//    every barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kKC = 6;  // MMA K tiles whose A fragments a warp holds at once
constexpr int kBytes = 0, kWords = 1, kRows = 2;  // LAYOUT, as ops/gf256_torch.PATHS
constexpr int kRowPad = 32;  // ROWS: a staged output row is C + kRowPad bytes


// byte offset of byte column c (= b*L + l) within row 0 of a [B, rows, L] view
__device__ __forceinline__ long long col_off(long long c, int L, long long sb,
                                             long long sl) {
  long long b;
  if (c < 0x7fffffffLL)
    b = (unsigned)c / (unsigned)L;
  else
    b = c / L;
  return b * sb + (c - b * L) * sl;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A * B for one m16n8k32 tile: A 16x32 s8 (row), B 32x8 s8 (col), D s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma's shared-memory matrix descriptor of B's tile (kt, nt) at
// `saddr` (ops/gf256_torch.b_operand's K-major layout without swizzle):
// 128-byte core matrices of 8 N rows x 16 K bytes, a K tile's two halves
// 128 B apart (LBO), N tiles 256 B apart (SBO).  Tile (kt, nt) starts
// (kt * NT + nt) * 256 B into B, so its descriptor is the first tile's plus
// 16 * (kt * NT + nt) (the address field counts 16-byte units).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// 16 bytes from `src` (16-byte aligned), or 16 zeros where `bytes` is 0
__device__ __forceinline__ void cp_async16z(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// D (+)= A * B for the warpgroup's 64 x N x 32 tile: A s8 from registers (the
// warp's 16 rows, m16n8k32's A fragment), B s8 K-major in shared memory,
// D s32 with N/2 registers per thread in m16n8k32's C order per 8 columns.
#define GF_D8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                 "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
__device__ __forceinline__ void wgmma_n32(int* d, const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p;\n}\n"
      : GF_D8(0), GF_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(int* d, const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p;\n}\n"
      : GF_D8(0), GF_D8(8), GF_D8(16), GF_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
#undef GF_D8

// the 4 bits of byte P of `nibbles` (each byte < 16) as 4 int8 lanes of 0/1
template <int P>
__device__ __forceinline__ uint32_t spread(uint32_t nibbles) {
  return (__byte_perm(nibbles, 0u, 0x4440u | P) * 0x00204081u) & 0x01010101u;
}

// A fragments of K tiles kc .. kc + kKC - 1 from a ring stage: (mt, kt) reg
// h + 2*k2 holds row g + 8h (column wcol + 2mt + h), K = 16*k2 + 4t .. +3:
// data byte 4kt + 2k2 + t/2, bits 4(t%2) .. +3.  ROWS: data row j's run
// starts (rlo + j * rsk) & 15 bytes into its stage row (rlo the low bits of
// the tile's row-b address, rsk of the row stride), so the lane reads the
// 4-byte words around its bytes and shifts them into place.
template <int MT, bool ROWS>
__device__ __forceinline__ void expand_a(uint32_t (&a)[MT][kKC][4], const uint8_t* st,
                                         int row, int wcol, int t, int kc, int KT,
                                         uint32_t rlo, uint32_t rsk) {
#pragma unroll
  for (int kk = 0; kk < kKC; ++kk) {
    if (kc + kk < KT) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int j = 4 * (kc + kk) + 2 * k2 + (t >> 1);
        uint32_t w[MT / 2];
        if constexpr (ROWS) {
          const int o = wcol + (int)((rlo + (uint32_t)j * rsk) & 15u);
          const uint32_t* src = reinterpret_cast<const uint32_t*>(st + j * row + (o & ~3));
          const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(o & 3);
          uint32_t x[MT / 2 + 1];
#pragma unroll
          for (int u = 0; u <= MT / 2; ++u) x[u] = src[u];
#pragma unroll
          for (int u = 0; u < MT / 2; ++u) w[u] = __byte_perm(x[u], x[u + 1], sel);
        } else if constexpr (MT == 2) {
          w[0] = *reinterpret_cast<const uint32_t*>(st + j * row + wcol);
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(st + j * row + wcol);
          w[0] = v.x;
          w[1] = v.y;
        }
#pragma unroll
        for (int u = 0; u < MT / 2; ++u) {
          const uint32_t nib = (w[u] >> (4 * (t & 1))) & 0x0F0F0F0Fu;
          a[2 * u][kk][2 * k2] = spread<0>(nib);
          a[2 * u][kk][1 + 2 * k2] = spread<1>(nib);
          a[2 * u + 1][kk][2 * k2] = spread<2>(nib);
          a[2 * u + 1][kk][1 + 2 * k2] = spread<3>(nib);
        }
      }
    }
  }
}

// One pass of wgmma for output bytes 4*G0 .. 4*(G0 + ng) - 1 over K tiles
// kc .. kc + kKC - 1 (the first K tile overwrites the sums), as one group:
// per M tile and K tile one instruction of N = 32 * ng.  Every descriptor is computed before the fence, so the
// instructions issue back to back (a descriptor computed between them makes
// ptxas fence each K tile).
template <int FORM, int MT, int NQ>
__device__ __forceinline__ void wgmma_pass(int (&acc)[MT][NQ][4],
                                           const uint32_t (&a)[MT][kKC][4], uint64_t desc0,
                                           int kc, int KT, int NT, int G0, int ng) {
  uint64_t desc[kKC];
#pragma unroll
  for (int kk = 0; kk < kKC; ++kk) desc[kk] = desc0 + 16 * (uint64_t)((kc + kk) * NT + 4 * G0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKC; ++kk) {
    if (kc + kk < KT) {
      const int acc_k = kc + kk;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (NQ == 8 && ng == 2)
          wgmma_n64(&acc[mt][0][0], a[mt][kk], desc[kk], acc_k);
        else
          wgmma_n32(&acc[mt][0][0], a[mt][kk], desc[kk], acc_k);
      }
    }
  }
  wgmma_commit();
}

// Epilogue of one pass: acc[mt][4gg + q][2h + e] is the sum of output byte
// 4(G0 + gg) + t, bit 2q + e, column wcol + 2mt + h, with its parity at
// that bit.  Packs each output byte of the lane's 2*MT columns and stores it
// (or XORs it in).
template <int MT, int NQ, bool WORDS>
__device__ __forceinline__ void epilogue(const int (&acc)[MT][NQ][4], int G0, int ng, int t,
                                         int m, const long long* off, const bool* live,
                                         uint8_t* out, long long o_sm, int accumulate) {
#pragma unroll
  for (int gg = 0; gg < NQ / 4; ++gg) {
    const int i = 4 * (G0 + gg) + t;
    if (gg >= ng || i >= m) continue;
    uint32_t byte[2 * MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            r |= (uint32_t)acc[mt][4 * gg + q][2 * h + e] & (1u << (2 * q + e));
        byte[2 * mt + h] = r;
      }
    const long long orow = (long long)i * o_sm;
    if constexpr (WORDS) {
#pragma unroll
      for (int u = 0; u < MT / 2; ++u) {
        if (!live[u]) continue;
        uint32_t v = __byte_perm(__byte_perm(byte[4 * u], byte[4 * u + 1], 0x0040u),
                                 __byte_perm(byte[4 * u + 2], byte[4 * u + 3], 0x0040u),
                                 0x5410u);
        uint32_t* dst = reinterpret_cast<uint32_t*>(out + off[u] + orow);
        if (accumulate) v ^= *dst;
        *dst = v;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2 * MT; ++u) {
        if (!live[u]) continue;
        uint8_t* dst = out + off[u] + orow;
        *dst = (uint8_t)(accumulate ? byte[u] ^ *dst : byte[u]);
      }
    }
  }
}

// ROWS: output rows 0..m-1 of a tile, staged at `ost` (row stride `orow`,
// C + kRowPad bytes), to their runs of n bytes at `p0` + i * o_sm.  Thread
// (i0, w) moves aligned 16-byte word w of rows i0, i0 + istep, ...: word w
// holds run bytes 16w - s .. 16w - s + 15 (s = the run's address & 15),
// read from the stage and shifted into place with byte permutes.  A word
// inside the run is stored whole; one at its ends shares bytes with the
// next run (the row's next tile, or the next row), so its 4-byte parts are
// stored whole where they lie inside, else only their own bytes, by 32-bit
// atomics on disjoint masks.
__device__ __forceinline__ void store_rows(const uint8_t* ost, int orow, uint8_t* p0,
                                           long long o_sm, int m, int n, int w, int i0,
                                           int istep, int accumulate) {
  for (int i = i0; i < m; i += istep) {
    uint8_t* p = p0 + i * o_sm;
    const int lo = 16 * w - (int)(reinterpret_cast<uintptr_t>(p) & 15);
    if (lo >= n) continue;
    const uint32_t* x = reinterpret_cast<const uint32_t*>(ost + i * orow + (lo & ~3));
    const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(lo & 3);
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __byte_perm(x[j], x[j + 1], sel);
    uint32_t* dst = reinterpret_cast<uint32_t*>(p + lo);
    if (lo >= 0 && lo + 16 <= n) {
      uint4 val = make_uint4(v[0], v[1], v[2], v[3]);
      if (accumulate) {
        const uint4 old = *reinterpret_cast<const uint4*>(dst);
        val = make_uint4(val.x ^ old.x, val.y ^ old.y, val.z ^ old.z, val.w ^ old.w);
      }
      *reinterpret_cast<uint4*>(dst) = val;
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = lo + 4 * j;  // the run offset of part j's first byte
      if (a + 4 <= 0 || a >= n) continue;
      if (a >= 0 && a + 4 <= n) {
        dst[j] = accumulate ? dst[j] ^ v[j] : v[j];
        continue;
      }
      uint32_t mask = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (a + e >= 0 && a + e < n) mask |= 0xFFu << (8 * e);
      if (accumulate) {
        atomicXor(dst + j, v[j] & mask);
      } else {
        atomicAnd(dst + j, ~mask);
        atomicOr(dst + j, v[j] & mask);
      }
    }
  }
}

// One block: `bop` is the B operand, [KT K tiles][NT = 4 NG N tiles][2 K
// halves][8 N rows][16 K bytes] (wgmma's canonical K-major layout; the
// mma.sync form loads its fragments from it too); the ring holds STAGES
// tiles of [kp][row] bytes (row >= C, and >= C + 16 for ROWS); ROWS stages
// a tile's m output rows after it, C + kRowPad bytes each.  FORM 0:
// mma.sync.m16n8k32 per warp; FORM 1 / 2: wgmma m64nNk32 per warpgroup,
// passes of N = 32 / 64 (one / two groups of 4 output bytes).
template <int FORM, int MT, int STAGES, int LAYOUT>
__global__ void __launch_bounds__(kMaxThreads)
    gf256_mma_kernel(const uint4* __restrict__ bop, int bop_bytes,
                     const uint8_t* __restrict__ data, long long d_sb, long long d_sk,
                     long long d_sl, uint8_t* __restrict__ out, long long o_sb,
                     long long o_sm, long long o_sl, int m, int k, int L,
                     long long ncols, int row, int accumulate) {
  constexpr int GS = FORM == 2 ? 2 : 1;  // groups of 4 output bytes per pass
  constexpr int NQ = 4 * GS;             // N tiles per pass
  constexpr bool ROWS = LAYOUT == kRows;
  extern __shared__ __align__(128) uint8_t smem[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kp = (k + 3) & ~3, KT = kp >> 2, NG = (m + 3) >> 2, NT = 4 * NG;
  const int C = (nthreads >> 5) * 16 * MT;  // byte columns per tile
  const int stage_bytes = kp * row;
  const long long tpr = (L + C - 1) / C;  // ROWS: tiles per shard row
  const long long ntiles = ROWS ? ncols / L * tpr : (ncols + C - 1) / C;
  uint8_t* bsh = smem;
  uint8_t* ring = smem + bop_bytes;
  uint8_t* ost = ring + STAGES * stage_bytes;  // ROWS: the staged output rows
  const int orow = C + kRowPad;
  const uint32_t bsh_s = (uint32_t)__cvta_generic_to_shared(bsh);
  const uint64_t desc0 = b_desc(bsh_s);

  // B operand -> shared memory, in the first cp.async group
  for (int q = tid; q < bop_bytes / 16; q += nthreads) cp_async16(bsh_s + 16 * q, bop + q);
  {  // rows k..kp-1 of every stage stay zero
    const int pad = (kp - k) * row;
    for (int q = tid; q < STAGES * pad; q += nthreads)
      ring[(q / pad) * stage_bytes + k * row + q % pad] = 0;
  }

  // ROWS: a thread moves 16-byte word rw of data rows rj0, rj0 + rjs, ...,
  // and of output rows the same: the C / 16 + 1 aligned words that cover a
  // run of C bytes at any shift
  const int nrw = C / 16 + 1, rw = tid % nrw, rj0 = tid / nrw, rjs = nthreads / nrw;

  auto load_tile = [&](long long tile, int s) {
    uint8_t* st = ring + s * stage_bytes;
    const long long c0 = tile * C;
    if constexpr (LAYOUT == kWords) {
      const int wc = C / 4;  // 4-column words per row; nthreads is a multiple
      const int w = tid % wc;
      const long long c = c0 + 4 * w;
      const bool ok = c < ncols;
      const uint8_t* src = data + (ok ? col_off(c, L, d_sb, d_sl) : 0);
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(st + 4 * w);
      for (int j = tid / wc; j < k; j += nthreads / wc)
        cp_async4(dst + j * row, ok ? src + j * d_sk : data, ok ? 4 : 0);
    } else if constexpr (ROWS) {
      if (rj0 >= rjs) return;  // the threads past whole rows of words
      const long long b = tile / tpr;
      const int l0 = (int)(tile - b * tpr) * C, n = min(C, L - l0);
      const uint8_t* run = data + b * d_sb + l0 + (long long)rj0 * d_sk;
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(st + rj0 * row + 16 * rw);
      for (int j = rj0; j < k; j += rjs, run += rjs * d_sk) {
        const uint8_t* a0 = reinterpret_cast<const uint8_t*>(
            reinterpret_cast<uintptr_t>(run) & ~(uintptr_t)15);
        const bool ok = a0 + 16 * rw < run + n;  // the word holds a byte of the run
        cp_async16z(dst + (j - rj0) * row, ok ? a0 + 16 * rw : a0, ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < k * C; q += nthreads) {
        const int j = q / C, cc = q % C;
        const long long c = c0 + cc;
        st[j * row + cc] = c < ncols ? data[col_off(c, L, d_sb, d_sl) + j * d_sk] : 0;
      }
    }
  };

  const long long first = blockIdx.x, step = gridDim.x;
  const int my_tiles = first < ntiles ? (int)((ntiles - 1 - first) / step + 1) : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < my_tiles) load_tile(first + s * step, s);
    cp_async_commit();
  }

  const int wcol = warp * 16 * MT + 2 * MT * g;  // the lane's first column in a tile
  uint32_t a[MT][kKC][4];                        // A fragments: [M tile][K tile][reg]

  for (int it = 0; it < my_tiles; ++it) {
    const int nxt = it + STAGES - 1;
    if (nxt < my_tiles) load_tile(first + nxt * step, nxt % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    if (FORM != 0 && it == 0)  // B, written by cp.async, is read by wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint8_t* st = ring + (it % STAGES) * stage_bytes;

    // The lane's 2*MT consecutive output columns: one word each 4 (WORDS
    // and ROWS, whose words go to the staged rows), else one offset each.
    const long long tile = first + it * step;
    constexpr bool WORDS = LAYOUT != kBytes;
    constexpr int kOffs = WORDS ? MT / 2 : 2 * MT;
    long long off[kOffs];
    bool live[kOffs];
    uint8_t* o_run = out;  // ROWS: the tile's first column of output row 0
    int n = 0;             // ROWS: the tile's columns before the row's end
    uint32_t rlo = 0;      // ROWS: low bits of the tile's data row address
    if constexpr (ROWS) {
      const long long b = tile / tpr;
      const int l0 = (int)(tile - b * tpr) * C;
#pragma unroll
      for (int u = 0; u < kOffs; ++u) {
        off[u] = wcol + 4 * u;
        live[u] = true;
      }
      o_run = out + b * o_sb + l0;
      n = min(C, L - l0);
      rlo = (uint32_t)reinterpret_cast<uintptr_t>(data) + (uint32_t)(b * d_sb);
    } else {
      const long long cbase = tile * C + wcol;
#pragma unroll
      for (int u = 0; u < kOffs; ++u) {
        const long long c = cbase + (WORDS ? 4 * u : u);
        live[u] = c < ncols;
        off[u] = live[u] ? col_off(c, L, o_sb, o_sl) : 0;
      }
    }

    if constexpr (FORM == 0) {
      for (int G0 = 0; G0 < NG; ++G0) {
        int acc[MT][4][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][q][r] = 0;
        for (int kc = 0; kc < KT; kc += kKC) {
          if (G0 == 0 || KT > kKC)
            expand_a<MT, ROWS>(a, st, row, wcol, t, kc, KT, rlo, (uint32_t)d_sk);
#pragma unroll
          for (int kk = 0; kk < kKC; ++kk) {
            if (kc + kk < KT) {
              // B fragment of N tile nt: K 4t..4t+3 and 16+4t.. of row g,
              // 4 bytes each at 16g + 4t of the tile's two K halves
              // (conflict-free)
              const uint8_t* bt =
                  bsh + (size_t)((kc + kk) * NT + 4 * G0) * 256 + 16 * g + 4 * t;
              uint32_t b[4][2];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                b[q][0] = *reinterpret_cast<const uint32_t*>(bt + 256 * q);
                b[q][1] = *reinterpret_cast<const uint32_t*>(bt + 256 * q + 128);
              }
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][q], a[mt][kk], b[q][0], b[q][1]);
            }
          }
        }
        if constexpr (ROWS)
          epilogue<MT, 4, true>(acc, G0, 1, t, m, off, live, ost, orow, 0);
        else
          epilogue<MT, 4, WORDS>(acc, G0, 1, t, m, off, live, out, o_sm, accumulate);
      }
    } else {
      // One pass per N = 32 * GS output bits: issue, wait, pack.  (A second
      // set of sums issued before packing the first makes ptxas serialize
      // every wgmma: it cannot tell the packed sums from the ones in flight.)
      for (int G0 = 0; G0 < NG; G0 += GS) {
        const int ng = NG - G0 < GS ? NG - G0 : GS;
        int acc[MT][NQ][4];
        for (int kc = 0; kc < KT; kc += kKC) {
          if (G0 == 0 || KT > kKC)
            expand_a<MT, ROWS>(a, st, row, wcol, t, kc, KT, rlo, (uint32_t)d_sk);
          wgmma_pass<FORM, MT, NQ>(acc, a, desc0, kc, KT, NT, G0, ng);
          wgmma_wait<0>();  // before the A fragments or the sums are touched
        }
        if constexpr (ROWS)
          epilogue<MT, NQ, true>(acc, G0, ng, t, m, off, live, ost, orow, 0);
        else
          epilogue<MT, NQ, WORDS>(acc, G0, ng, t, m, off, live, out, o_sm, accumulate);
      }
    }
    if constexpr (ROWS) {
      __syncthreads();  // every output row of the tile is staged
      if (rj0 < rjs) store_rows(ost, orow, o_run, o_sm, m, n, rw, rj0, rjs, accumulate);
    }
    __syncthreads();  // the stage is refilled STAGES - 1 tiles later
  }
  cp_async_wait<0>();
}

template <int FORM, int MT, int STAGES, int LAYOUT>
cudaError_t launch(int device, const void* bop, int bop_bytes, const uint8_t* data,
                   long long d_sb, long long d_sk, long long d_sl, uint8_t* out,
                   long long o_sb, long long o_sm, long long o_sl, int m, int k, int L,
                   long long B, int threads, int row, int smem, int accumulate,
                   cudaStream_t stream) {
  auto kernel = gf256_mma_kernel<FORM, MT, STAGES, LAYOUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long C = (long long)(threads / 32) * 16 * MT;  // columns per tile
  // ROWS keeps each tile in one shard row
  const long long ntiles = LAYOUT == kRows ? B * ((L + C - 1) / C) : (B * L + C - 1) / C;
  const long long grid = ntiles < (long long)per_sm * sms ? ntiles : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const uint4*>(bop), bop_bytes, data, d_sb, d_sk, d_sl, out, o_sb, o_sm,
      o_sl, m, k, L, B * L, row, accumulate);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`; returns cudaGetLastError() (0 on success).
// `bop` is ops/gf256_torch.b_operand of the [m, k] matrix (bop_bytes = 64 *
// ceil4(m) * ceil4(k)); `form` 0 (mma.sync), 1 or 2 (wgmma passes of N =
// 32, 64); `warps` warps of 32 threads per block (a multiple of 4 for
// wgmma), `m_tiles` M tiles per warp (2, or 4 with forms 0 and 1), `stages`
// ring stages (2 or 3); `row` is the ring's row stride in bytes (>= warps *
// 16 * m_tiles, + 16 for ROWS, a multiple of 16) and `smem` the block's
// dynamic shared memory (>= bop_bytes + stages * ceil4(k) * row), both from
// ops/gf256_torch.launch_shape.  `layout` 0 (BYTES), 1 (WORDS) or 2 (ROWS),
// from ops/gf256_torch.launch_path; one the view does not allow is refused.
// With `accumulate` the result is XORed into `out` instead of stored.
extern "C" int gf256_matmul_launch(int device, const void* bop, int bop_bytes,
                                   const void* data, long long d_sb, long long d_sk,
                                   long long d_sl, void* out, long long o_sb,
                                   long long o_sm, long long o_sl, int m, int k, int L,
                                   long long B, int form, int warps, int m_tiles,
                                   int stages, int row, int smem, int accumulate,
                                   int layout, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kp = (k + 3) & ~3, mp = (m + 3) & ~3;
  const int threads = warps * 32;
  const bool unit = d_sl == 1 && o_sl == 1;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out) |
        (uintptr_t)d_sb | (uintptr_t)d_sk | (uintptr_t)o_sb | (uintptr_t)o_sm) &
       3) == 0;
  if (m <= 0 || k <= 0 || L <= 0 || B <= 0 || warps < 1 || threads > kMaxThreads ||
      (form != 0 && warps % 4 != 0) || bop_bytes != 64 * mp * kp ||
      row < warps * 16 * m_tiles || row % 16 != 0 ||
      (long long)smem < (long long)bop_bytes + (long long)stages * kp * row ||
      (layout == kWords && !(unit && aligned && L % 4 == 0)) ||
      (layout == kRows &&
       !(unit && row >= warps * 16 * m_tiles + 16 &&
         (long long)smem >= (long long)bop_bytes + (long long)stages * kp * row +
                                (long long)m * (warps * 16 * m_tiles + kRowPad))) ||
      layout < kBytes || layout > kRows)
    return (int)cudaErrorInvalidValue;
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GF_LAUNCH_AS(F, MT, ST, LAY)                                                      \
  if (layout == LAY)                                                                     \
    return (int)launch<F, MT, ST, LAY>(device, bop, bop_bytes, d, d_sb, d_sk, d_sl, o,   \
                                       o_sb, o_sm, o_sl, m, k, L, B, threads, row, smem, \
                                       accumulate, s);
#define GF_LAUNCH(F, MT, ST)                      \
  if (form == F && m_tiles == MT && stages == ST) { \
    GF_LAUNCH_AS(F, MT, ST, kBytes)               \
    GF_LAUNCH_AS(F, MT, ST, kWords)               \
    GF_LAUNCH_AS(F, MT, ST, kRows)                \
  }
  GF_LAUNCH(0, 2, 2)
  GF_LAUNCH(0, 2, 3)
  GF_LAUNCH(0, 4, 2)
  GF_LAUNCH(0, 4, 3)
  GF_LAUNCH(1, 2, 2)
  GF_LAUNCH(1, 2, 3)
  GF_LAUNCH(1, 4, 2)
  GF_LAUNCH(1, 4, 3)
  GF_LAUNCH(2, 2, 2)
  GF_LAUNCH(2, 2, 3)
#undef GF_LAUNCH
#undef GF_LAUNCH_AS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gf256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
