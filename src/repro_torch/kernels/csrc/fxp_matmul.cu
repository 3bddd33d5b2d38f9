// fxp_matmul: the whole overflow-safe integer dot of the regressions, one
// launch a dot, on the int8 tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fxp_matmul.py::fxp_matmul
// (_fxp_kernel, a tiled MXU s8 matmul with K as the sequential grid axis)
// together with the JAX dispatch function around it,
// repro/kernels/dispatch.py::hybrid_matmul, which splits both operands
// into int8-range limbs, runs the kernel on every limb pair and K-chunk,
// and combines the int32 partials in float32 (XLA fused those passes
// around the Pallas call).  Here one launch does all of it:
//
//   out[l, m, n] = sum over limb pairs (ia, ib), in order, of
//                  (wa * wb) * sum over K-chunks c, in order, of
//                  float(P[ia, ib, c, l, m, n]),
//   P[...] = sum_{k in chunk c} limb_ia(A[l, m, k]) * limb_ib(B[l, k, n]),
//
// with the float operations of quantize.hybrid_dot (__int2float_rn, then
// __fadd_rn and __fmul_rn, the first term taken as it is), so the result is
// equal bit for bit.  An int8 operand is one limb; an int16 one is its high
// limb (x >> 8, signed, weight 256) and its low limb (x & 0xFF, unsigned).
// Every P is an exact int32: a limb product is below 2^16 and a chunk holds
// at most 4096 k, so |P| < 2^28.
//
// What bounds it on the H100: bytes.  The main paths read the resident
// dataset A (1 GiB of int8 at 256 lanes x 65,536 rows x 64 features) once a
// dot and meet it with 2-32 limb columns of B, a few int8 multiply-adds a
// byte: far below the tensor cores' rate, but at 8-32 limb columns far above
// what the CUDA cores sustain.  The design:
//   * the limbs are split in registers, A's and B's alike (__byte_perm), and
//     go to mma.sync.m16n8k32 as .s8 (high limb, or an int8 value) or .u8
//     (low limb); a K-chunk's partial accumulates in the int32 fragments;
//   * a thread loads whole 16- or 8-byte pieces of A.  The products over k
//     are exact integers, so the order of k inside a fragment is free: each
//     thread takes its fragment's k from consecutive bytes, and builds B's
//     fragments with the same order;
//   * rows (A contiguous along k, the forward X.W): a thread loads 16 bytes
//     of a row and uses them as they are; B's fragments of the k-block are
//     built once a block into shared memory; past 8 columns a warp's
//     output rows leave through shared memory in 16-byte pieces;
//   * cols (A contiguous along m, the gradient X^T.R on the transposed view
//     of the resident rows): a thread loads 8 bytes (8 or 4 m) of 8
//     consecutive k rows and transposes them in 4 x 4 byte blocks, its B
//     values (R itself, int16) are loaded and split beside them, one k-step
//     ahead; the block's warps take the chunk's k-steps in turn and sum into
//     shared memory;
//   * one block takes one K-chunk of its rows.  With one chunk the float
//     result is formed from the fragments or shared sums; with several, the
//     blocks write exact int32 partials to a scratch the wrapper allocates
//     (about 21 MB at the multinomial's C = 10) and the last block of a tile
//     to finish (an integer counter, no float atomics) sums them in chunk
//     order;
//   * ragged M and K, unaligned views and other strides take predicated
//     element loads inside the same kernels;
//   * the row groups a rows block walks are a launch argument (the
//     wrapper's block_m, chosen by tuning.autotune.block_shapes; 8 by
//     default): fewer groups, more blocks.  Each group's rows, and so each
//     output bit, are the same at any count;
//   * int32_out (int8 x int8 only, one limb pair): the output is the int32
//     sum itself, the chunks' partials added in int32 in chunk order with
//     two's-complement wrap, as an int32 accumulator (the TPU kernel's
//     own output; kernels.ops.fxp_matmul).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;          // columns of b a launch takes
constexpr int kRowWarps = 8;       // rows kernel: warps a block
constexpr int kColWarps = 4;       // cols kernel: warps a block

// m16 tiles a warp owns: rows, 32 (int8) or 16 (int16) rows; cols, 64 or
// 32 columns m (a thread's 8 bytes of a k row)
template <typename TA>
__host__ __device__ constexpr int row_tiles() {
  return 2 / static_cast<int>(sizeof(TA));
}
template <typename TA>
__host__ __device__ constexpr int col_tiles() {
  return 4 / static_cast<int>(sizeof(TA));
}

struct Args {
  const void* A;
  const void* B;
  float* out;
  int32_t* scratch;                // (L, n_chunks, pairs, M, N), K > 1 chunk
  int32_t* counters;               // (L, blocks along m), zeroed
  int M, K, N, kc, n_chunks;
  long long sAl, sAm, sAk, sBl, sBk, sBn, sOl, sOm;
  int vec;                         // A's pieces may be loaded whole
  int groups;                      // rows kernel: row groups a block walks
  int int32_out;                   // out holds int32 sums (one limb pair)
};

// Limb i of a T value: weight and whether it is signed.  An int8 value is
// its own limb; an int16 one is 256 * hi + lo.
template <typename T>
__device__ __forceinline__ constexpr float limb_weight(int i) {
  return (sizeof(T) == 2 && i == 0) ? 256.0f : 1.0f;
}

template <typename TA, typename TB>
__device__ __forceinline__ constexpr float pair_weight(int p) {
  return limb_weight<TA>(p / static_cast<int>(sizeof(TB))) *
         limb_weight<TB>(p % static_cast<int>(sizeof(TB)));
}

// D += A * B on the tensor cores; SA, SB: the limb is signed (.s8) or not.
template <bool SA, bool SB>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
#define FXP_MMA(TYPES)                                                       \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." TYPES ".s32 "                \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"              \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (SA && SB) {
    FXP_MMA("s8.s8");
  } else if constexpr (SA) {
    FXP_MMA("s8.u8");
  } else if constexpr (SB) {
    FXP_MMA("u8.s8");
  } else {
    FXP_MMA("u8.u8");
  }
#undef FXP_MMA
}

// All limb pairs of one fragment: acc[ia * BL + ib][nb] += a[ia] * b[ib][nb].
template <typename TA, typename TB, int NB>
__device__ __forceinline__ void mma_pairs(
    int (&acc)[sizeof(TA) * sizeof(TB)][NB][4],
    const uint32_t (&a)[sizeof(TA)][4],
    const uint32_t (&b)[sizeof(TB)][NB][2]) {
#pragma unroll
  for (int ia = 0; ia < static_cast<int>(sizeof(TA)); ++ia)
#pragma unroll
    for (int ib = 0; ib < static_cast<int>(sizeof(TB)); ++ib)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        constexpr bool a8 = sizeof(TA) == 1, b8 = sizeof(TB) == 1;
        int (&d)[4] = acc[ia * sizeof(TB) + ib][nb];
        if (ia == 0 && ib == 0) mma<true, true>(d, a[ia], b[ib][nb]);
        else if (ia == 0) mma<true, b8>(d, a[ia], b[ib][nb]);
        else if (ib == 0) mma<a8, true>(d, a[ia], b[ib][nb]);
        else mma<a8, b8>(d, a[ia], b[ib][nb]);
      }
}

// Words of four int16s in (w0, w1): their high (0x7531) or low (0x6420) bytes.
__device__ __forceinline__ uint32_t limb_word(uint32_t w0, uint32_t w1,
                                              int limb) {
  return __byte_perm(w0, w1, limb == 0 ? 0x7531 : 0x6420);
}

// 4 x 4 bytes: r[i] holds k = i at m = 0..3; t[j] gets k = 0..3 at m = j.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t* t) {
  const uint32_t x0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t x1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t y0 = __byte_perm(r2, r3, 0x5140);
  const uint32_t y1 = __byte_perm(r2, r3, 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// The limb words of four consecutive-k values of B.
template <typename TB>
__device__ __forceinline__ void pack_b(const int (&v)[4],
                                       uint32_t (&w)[sizeof(TB)]) {
  if constexpr (sizeof(TB) == 1) {
    w[0] = __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                       __byte_perm(v[2], v[3], 0x0040), 0x5410);
  } else {
    const uint32_t p = __byte_perm(v[0], v[1], 0x5410);
    const uint32_t q = __byte_perm(v[2], v[3], 0x5410);
    w[0] = limb_word(p, q, 0);
    w[1] = limb_word(p, q, 1);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t raw_bits(T v) {
  return sizeof(T) == 1 ? static_cast<uint32_t>(static_cast<uint8_t>(v))
                        : static_cast<uint32_t>(static_cast<uint16_t>(v));
}

// BYTES bytes of A from p on: whole when allowed, else element by element at
// stride s, with elements at and past `valid` read as 0.
template <typename TA, int BYTES, typename V>
__device__ __forceinline__ V load_piece(const TA* p, long long s, int valid,
                                        bool vec) {
  constexpr int E = BYTES / sizeof(TA);
  if (vec && valid >= E) return __ldg(reinterpret_cast<const V*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < valid) {
      const int byte = e * static_cast<int>(sizeof(TA));
      w[byte / 4] |= raw_bits(__ldg(p + e * s)) << (8 * (byte % 4));
    }
  }
  if constexpr (BYTES == 16)
    return make_uint4(w[0], w[1], w[2], w[3]);
  else
    return make_uint2(w[0], w[1]);
}

// One output element from its pairs' chunk sums, in hybrid_dot's order.
template <typename TA, typename TB>
__device__ __forceinline__ float combine_pairs(const float* sums) {
  float o = 0.0f;
#pragma unroll
  for (int p = 0; p < static_cast<int>(sizeof(TA) * sizeof(TB)); ++p) {
    const float t = __fmul_rn(sums[p], pair_weight<TA, TB>(p));
    o = p == 0 ? t : __fadd_rn(o, t);
  }
  return o;
}

// The same from one chunk's int32 partials.
template <typename TA, typename TB>
__device__ __forceinline__ float combine_one(const int* parts, int stride) {
  float sums[sizeof(TA) * sizeof(TB)];
#pragma unroll
  for (int p = 0; p < static_cast<int>(sizeof(TA) * sizeof(TB)); ++p)
    sums[p] = __int2float_rn(parts[p * stride]);
  return combine_pairs<TA, TB>(sums);
}

// The same from every chunk's partials in the scratch; s points at chunk 0,
// pair 0 of the element, `stride` elements apart from one pair to the next.
// With int32_out (one pair) the int32 sum of the chunks, in chunk order with
// two's-complement wrap, as float bits.
template <typename TA, typename TB>
__device__ __forceinline__ float combine_chunks(const int32_t* s, int n_chunks,
                                                long long stride,
                                                bool int32_out) {
  constexpr int P = sizeof(TA) * sizeof(TB);
  if (int32_out) {
    uint32_t acc = 0u;
    for (int c = 0; c < n_chunks; ++c)
      acc += static_cast<uint32_t>(__ldcg(s + c * P * stride));
    return __int_as_float(static_cast<int>(acc));
  }
  float sums[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float acc = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const float f = __int2float_rn(__ldcg(s + (c * P + p) * stride));
      acc = c == 0 ? f : __fadd_rn(acc, f);
    }
    sums[p] = acc;
  }
  return combine_pairs<TA, TB>(sums);
}

// A warp's `rows` output rows of N floats, staged in `tile` (row stride N),
// to dst (row stride sOm): in whole 16-byte pieces when the rows are
// contiguous and aligned there, else element by element.
__device__ __forceinline__ void store_tile(const float* tile, float* dst,
                                           int rows, int N, long long sOm,
                                           int lane) {
  const int count = rows * N;
  if (sOm == N && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = count / 4;
    for (int i = lane; i < n4; i += 32)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(tile)[i];
    for (int i = 4 * n4 + lane; i < count; i += 32) dst[i] = tile[i];
  } else {
    for (int i = lane; i < count; i += 32) dst[(i / N) * sOm + i % N] = tile[i];
  }
}

// After a block wrote its chunk's partials: true in the block whose chunk is
// the tile's last to finish (block-uniform).
__device__ __forceinline__ bool last_of_tile(const Args& a, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(a.counters + blockIdx.z * gridDim.x + blockIdx.x, 1) ==
            a.n_chunks - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// rows: A[l, m, k] read along k.  Warp w of the block owns 16 * MT rows of
// each of a.groups row groups; for each 64-k block a thread loads 16
// bytes (int8) or 32 (int16) of each of its rows, k = kb + 16 * tig + [0,
// 16): step s of the block uses k + 8 s + [0, 4) as its fragment's low k
// half and k + 8 s + [4, 8) as the high one.
// ---------------------------------------------------------------------------
template <typename TA, typename TB, int NB>
__global__ void __launch_bounds__(kRowWarps * 32, 2)
fxp_rows_kernel(const Args a) {
  constexpr int AL = sizeof(TA), BL = sizeof(TB), P = AL * BL;
  constexpr int MT = row_tiles<TA>();
  constexpr int SEG = sizeof(TA);          // 16-byte pieces a row a k-block
  constexpr int E = 16 / sizeof(TA);       // elements a piece
  constexpr int GROWS = kRowWarps * 16 * MT;  // rows of a row group
  __shared__ uint32_t bs[2][BL][NB][2][32];
  // NB = 2: a row of the output spans two n8 blocks, and leaves through
  // the warp's tile in shared memory (row stride N)
  __shared__ __align__(16)
      float os[kRowWarps][NB > 1 ? 16 * MT * kMaxN : 1];
  __shared__ int flag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.y * a.kc, k1 = min(k0 + a.kc, a.K);
  const int nkb = (k1 - k0 + 63) / 64;
  const TA* Al = static_cast<const TA*>(a.A) + blockIdx.z * a.sAl;
  const TB* Bl = static_cast<const TB*>(a.B) + blockIdx.z * a.sBl;
  const int mw = blockIdx.x * a.groups * GROWS + warp * 16 * MT;
  const bool vec = a.vec != 0;

  auto row_of = [&](int grp, int t, int h) {
    return mw + grp * GROWS + 16 * t + 8 * h + g;
  };
  auto load_a = [&](int it, uint4 (&v)[MT][2][SEG]) {
    const int grp = it / nkb;
    const int kt = k0 + (it % nkb) * 64 + 16 * tig;
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row_of(grp, t, h);
#pragma unroll
        for (int sg = 0; sg < SEG; ++sg) {
          const int k = kt + sg * E;
          v[t][h][sg] = m < a.M
              ? load_piece<TA, 16, uint4>(Al + m * a.sAm + k * a.sAk, a.sAk,
                                          k1 - k, vec)
              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
  };
  // B's fragments of the k-block at kb, in the order load_a gives A's k
  auto stage_b = [&](int kb) {
    for (int i = threadIdx.x; i < 2 * NB * 2 * 32; i += kRowWarps * 32) {
      const int ln = i & 31, j = (i >> 5) & 1, nb = (i >> 6) % NB;
      const int s = (i >> 6) / NB;
      const int n = nb * 8 + (ln >> 2);
      const int k = kb + 16 * (ln & 3) + 8 * s + 4 * j;
      int v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (n < a.N && k + e < k1)
                   ? static_cast<int>(__ldg(Bl + (k + e) * a.sBk + n * a.sBn))
                   : 0;
      uint32_t w[BL];
      pack_b<TB>(v, w);
#pragma unroll
      for (int ib = 0; ib < BL; ++ib) bs[s][ib][nb][j][ln] = w[ib];
    }
  };
  auto a_frag = [&](const uint4 (&v)[2][SEG], int s, int ia,
                    uint32_t (&f)[4]) {
    if constexpr (sizeof(TA) == 1) {
      const uint4 lo = v[0][0], hi = v[1][0];
      f[0] = s == 0 ? lo.x : lo.z;
      f[1] = s == 0 ? hi.x : hi.z;
      f[2] = s == 0 ? lo.y : lo.w;
      f[3] = s == 0 ? hi.y : hi.w;
    } else {
      const uint4 lo = v[0][s], hi = v[1][s];
      f[0] = limb_word(lo.x, lo.y, ia);
      f[1] = limb_word(hi.x, hi.y, ia);
      f[2] = limb_word(lo.z, lo.w, ia);
      f[3] = limb_word(hi.z, hi.w, ia);
    }
  };
  auto scratch_of = [&](int p, int m, int n) {
    return ((static_cast<long long>(blockIdx.z) * a.n_chunks + blockIdx.y) *
                P + p) * a.M * a.N + static_cast<long long>(m) * a.N + n;
  };
  auto out_of = [&](int m, int n) {
    return a.out + blockIdx.z * a.sOl + m * a.sOm + n;
  };

  int acc[MT][P][NB][4];
  uint4 cur[MT][2][SEG], nxt[MT][2][SEG];
  const int iters = a.groups * nkb;
  load_a(0, nxt);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int sg = 0; sg < SEG; ++sg) cur[t][h][sg] = nxt[t][h][sg];
    if (it + 1 < iters) load_a(it + 1, nxt);
    const int kbi = it % nkb;
    if (kbi == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[t][p][nb][i] = 0;
    }
    if (nkb > 1 || it == 0) {              // block-uniform
      __syncthreads();
      stage_b(k0 + kbi * 64);
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t bf[BL][NB][2];
#pragma unroll
      for (int ib = 0; ib < BL; ++ib)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < 2; ++j) bf[ib][nb][j] = bs[s][ib][nb][j][lane];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        uint32_t af[AL][4];
#pragma unroll
        for (int ia = 0; ia < AL; ++ia) a_frag(cur[t], s, ia, af[ia]);
        mma_pairs<TA, TB, NB>(acc[t], af, bf);
      }
    }
    if (kbi == nkb - 1) {
      // one chunk: the float results, stored or staged; several: the int32
      // partials, to the scratch
      const int grp = it / nkb, r0 = row_of(grp, 0, 0) - g;
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = row_of(grp, t, h), n = nb * 8 + 2 * tig + e;
              if (n >= a.N) continue;
              int parts[P];
#pragma unroll
              for (int p = 0; p < P; ++p) parts[p] = acc[t][p][nb][2 * h + e];
              if (a.n_chunks == 1) {
                const float v = a.int32_out ? __int_as_float(parts[0])
                                            : combine_one<TA, TB>(parts, 1);
                if (NB > 1)
                  os[warp][(m - r0) * a.N + n] = v;
                else if (m < a.M)
                  *out_of(m, n) = v;
              } else if (m < a.M) {
#pragma unroll
                for (int p = 0; p < P; ++p)
                  a.scratch[scratch_of(p, m, n)] = parts[p];
              }
            }
      if (NB > 1 && a.n_chunks == 1 && r0 < a.M) {
        __syncwarp();
        store_tile(os[warp], out_of(r0, 0), min(16 * MT, a.M - r0), a.N,
                   a.sOm, lane);
        __syncwarp();
      }
    }
  }
  if (a.n_chunks == 1 || !last_of_tile(a, &flag)) return;
  const long long stride = static_cast<long long>(a.M) * a.N;
  for (int grp = 0; grp < a.groups; ++grp)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = row_of(grp, t, h), n = nb * 8 + 2 * tig + e;
            if (m < a.M && n < a.N)
              *out_of(m, n) = combine_chunks<TA, TB>(
                  a.scratch + (static_cast<long long>(blockIdx.z) *
                               a.n_chunks * P) * stride +
                      static_cast<long long>(m) * a.N + n,
                  a.n_chunks, stride, a.int32_out != 0);
          }
}

// ---------------------------------------------------------------------------
// cols: A[l, m, k] read along m (sAm = 1).  The block owns BM = 16 * MT
// columns m of one K-chunk; its warps take the chunk's 32-k steps in turn.
// In a step, thread (g, tig) loads 8 bytes (MW = 2 MT values of m, from m0 +
// MW g) of each of the rows k = step + 8 tig + [0, 8) and transposes them:
// rows [0, 4) are its fragment's low k half, [4, 8) the high one; tile t's
// fragment row g is m = MW g + 2 t and row g + 8 is MW g + 2 t + 1.
// ---------------------------------------------------------------------------
template <typename TA, typename TB, int NB>
__global__ void __launch_bounds__(kColWarps * 32)
fxp_cols_kernel(const Args a) {
  constexpr int AL = sizeof(TA), BL = sizeof(TB), P = AL * BL;
  constexpr int MT = col_tiles<TA>();
  constexpr int kThreads = kColWarps * 32;
  constexpr int MW = 2 * MT;               // m a thread loads: 8 bytes
  constexpr int BM = 16 * MT;
  __shared__ int red[P][BM][NB * 8];
  __shared__ int flag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.y * a.kc, k1 = min(k0 + a.kc, a.K);
  const int m0 = blockIdx.x * BM;
  const TA* Al = static_cast<const TA*>(a.A) + blockIdx.z * a.sAl + m0 +
                 MW * g;
  const TB* Bl = static_cast<const TB*>(a.B) + blockIdx.z * a.sBl;
  const int mvalid = a.M - (m0 + MW * g);
  const bool vec = a.vec != 0;

  for (int i = threadIdx.x; i < P * BM * NB * 8; i += kThreads)
    (&red[0][0][0])[i] = 0;

  auto load = [&](int kk, uint2 (&ar)[8], int (&br)[NB][8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = kk + 8 * tig + r;
      ar[r] = k < k1 ? load_piece<TA, 8, uint2>(Al + k * a.sAk, 1, mvalid,
                                                vec)
                     : make_uint2(0u, 0u);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int n = nb * 8 + g;
        br[nb][r] = (k < k1 && n < a.N)
                        ? static_cast<int>(__ldg(Bl + k * a.sBk + n * a.sBn))
                        : 0;
      }
    }
  };

  int acc[MT][P][NB][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][p][nb][i] = 0;
  uint2 ar[8];
  int br[NB][8];
  int kk = k0 + 32 * warp;
  if (kk < k1) load(kk, ar, br);
#pragma unroll 1
  for (; kk < k1; kk += 32 * kColWarps) {
    uint2 ca[8];
    int cb[NB][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      ca[r] = ar[r];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) cb[nb][r] = br[nb][r];
    }
    if (kk + 32 * kColWarps < k1) load(kk + 32 * kColWarps, ar, br);
    // A: T[ia][h][j] holds k rows 4 h + [0, 4) at m = MW g + j
    uint32_t T[AL][2][MW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (sizeof(TA) == 1) {
        transpose4(ca[4 * h].x, ca[4 * h + 1].x, ca[4 * h + 2].x,
                   ca[4 * h + 3].x, &T[0][h][0]);
        transpose4(ca[4 * h].y, ca[4 * h + 1].y, ca[4 * h + 2].y,
                   ca[4 * h + 3].y, &T[0][h][4]);
      } else {
#pragma unroll
        for (int ia = 0; ia < AL; ++ia) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = limb_word(ca[4 * h + i].x, ca[4 * h + i].y, ia);
          transpose4(w[0], w[1], w[2], w[3], &T[ia][h][0]);
        }
      }
    }
    uint32_t bf[BL][NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int v[4] = {cb[nb][4 * j], cb[nb][4 * j + 1], cb[nb][4 * j + 2],
                          cb[nb][4 * j + 3]};
        uint32_t w[BL];
        pack_b<TB>(v, w);
#pragma unroll
        for (int ib = 0; ib < BL; ++ib) bf[ib][nb][j] = w[ib];
      }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      uint32_t af[AL][4];
#pragma unroll
      for (int ia = 0; ia < AL; ++ia) {
        af[ia][0] = T[ia][0][2 * t];
        af[ia][1] = T[ia][0][2 * t + 1];
        af[ia][2] = T[ia][1][2 * t];
        af[ia][3] = T[ia][1][2 * t + 1];
      }
      mma_pairs<TA, TB, NB>(acc[t], af, bf);
    }
  }
  __syncthreads();                         // red is zeroed
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          atomicAdd(&red[p][MW * g + 2 * t + (i >> 1)][nb * 8 + 2 * tig +
                                                       (i & 1)],
                    acc[t][p][nb][i]);
  __syncthreads();

  const long long stride = static_cast<long long>(a.M) * a.N;
  const long long lane_chunks = static_cast<long long>(blockIdx.z) *
                                a.n_chunks * P * stride;
  for (int i = threadIdx.x; i < BM * a.N; i += kThreads) {
    const int ml = i / a.N, n = i % a.N, m = m0 + ml;
    if (m >= a.M) continue;
    if (a.n_chunks == 1) {
      a.out[blockIdx.z * a.sOl + m * a.sOm + n] =
          a.int32_out ? __int_as_float(red[0][ml][n])
                      : combine_one<TA, TB>(&red[0][ml][n], BM * NB * 8);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
        a.scratch[lane_chunks + (blockIdx.y * P + p) * stride +
                  static_cast<long long>(m) * a.N + n] = red[p][ml][n];
    }
  }
  if (a.n_chunks == 1 || !last_of_tile(a, &flag)) return;
  for (int i = threadIdx.x; i < BM * a.N; i += kThreads) {
    const int ml = i / a.N, n = i % a.N, m = m0 + ml;
    if (m < a.M)
      a.out[blockIdx.z * a.sOl + m * a.sOm + n] = combine_chunks<TA, TB>(
          a.scratch + lane_chunks + static_cast<long long>(m) * a.N + n,
          a.n_chunks, stride, a.int32_out != 0);
  }
}

template <typename TA>
int blocks_m(int M, int cols, int groups) {
  const int bm = cols ? 16 * col_tiles<TA>()
                      : groups * kRowWarps * 16 * row_tiles<TA>();
  return (M + bm - 1) / bm;
}

template <typename TA, typename TB, int NB>
void launch(const Args& a, int L, int cols, cudaStream_t stream) {
  const dim3 grid(blocks_m<TA>(a.M, cols, a.groups), a.n_chunks, L);
  if (cols)
    fxp_cols_kernel<TA, TB, NB><<<grid, kColWarps * 32, 0, stream>>>(a);
  else
    fxp_rows_kernel<TA, TB, NB><<<grid, kRowWarps * 32, 0, stream>>>(a);
}

template <typename TA, typename TB>
void launch_nb(const Args& a, int L, int cols, cudaStream_t stream) {
  if (a.N <= 8)
    launch<TA, TB, 1>(a, L, cols, stream);
  else
    launch<TA, TB, 2>(a, L, cols, stream);
}

}  // namespace

// Blocks along m of a launch at `groups` row groups a rows block: the
// wrapper sizes the counters with it, at the groups it launches with.
extern "C" int fxp_matmul_blocks(int M, int a_bytes, int cols, int groups) {
  return a_bytes == 1 ? blocks_m<int8_t>(M, cols, groups)
                      : blocks_m<int16_t>(M, cols, groups);
}

// a_bytes, b_bytes: 1 for int8, 2 for int16.  cols: 1 when A is read along m
// (sAm = 1), 0 along k.  vec: A's pieces may be loaded whole (16 bytes along
// k, or 8 along m, aligned).  scratch and counters are used only when K
// takes more than one chunk.  groups: row groups a rows block walks (>= 1;
// kernels/fxp_matmul.py's ROW_GROUPS, 8, by default).  int32_out: out is int32 (int8 a and b only).
// Strides are in elements; the output's column stride is 1.  Returns
// cudaGetLastError() after the launch.
extern "C" int fxp_matmul_launch(
    const void* A, int a_bytes, const void* B, int b_bytes, void* out,
    void* scratch, void* counters, int L, int M, int K, int N, int kc,
    long long sAl, long long sAm, long long sAk, long long sBl, long long sBk,
    long long sBn, long long sOl, long long sOm, int cols, int vec,
    int groups, int int32_out, void* stream) {
  if (N < 1 || N > kMaxN || kc < 1 || K < 1 || (a_bytes != 1 && a_bytes != 2)
      || (b_bytes != 1 && b_bytes != 2) || (cols && sAm != 1) || groups < 1
      || (int32_out && (a_bytes != 1 || b_bytes != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (K + kc - 1) / kc;
  if (n_chunks > 1 && (scratch == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{A, B, static_cast<float*>(out), static_cast<int32_t*>(scratch),
         static_cast<int32_t*>(counters), M, K, N, kc, n_chunks,
         sAl, sAm, sAk, sBl, sBk, sBn, sOl, sOm, vec, groups, int32_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bytes == 1 && b_bytes == 1) launch_nb<int8_t, int8_t>(a, L, cols, s);
  if (a_bytes == 1 && b_bytes == 2) launch_nb<int8_t, int16_t>(a, L, cols, s);
  if (a_bytes == 2 && b_bytes == 1) launch_nb<int16_t, int8_t>(a, L, cols, s);
  if (a_bytes == 2 && b_bytes == 2) launch_nb<int16_t, int16_t>(a, L, cols, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fxp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
