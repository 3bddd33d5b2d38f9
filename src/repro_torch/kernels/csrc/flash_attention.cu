// flash_attention: causal (or full) grouped-query attention forward for
// NVIDIA Hopper (sm_90a), online softmax over key tiles.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  There the grid's last dimension walks the key blocks in
// order on one core and carries the running max m, sum l and accumulator in
// VMEM scratch from one grid step to the next.  Blocks of a GPU run in no
// order, so here one block owns one (batch, head, 64-row query tile) and
// walks the key tiles itself, keeping m, l and the accumulator in
// registers:
//
//   s   = (q . k^T) * scale                       float32, scale = 1/sqrt(D)
//   s   = -1e30 where masked (causal: key > query; keys >= S)
//   m'  = max(m, rowmax(s));  p = exp(s - m') (0 where masked)
//   l   = l * exp(m - m') + rowsum(p)
//   acc = acc * exp(m - m') + round_to_v_dtype(p) . v
//   out = acc / max(l, 1e-30)                      cast to q's dtype
//
// p is rounded to v's dtype before the product, as the TPU kernel does
// (flash_attention.py:61-62); l sums the unrounded p.  Key tiles strictly
// after the query tile's last row are skipped (causal), and the grid starts
// the longest query tiles first.  Query head h reads key/value head
// h / (H / Kh).  Any S >= 1: rows and keys past S are masked, and a row
// with no unmasked key gives 0.  The plain PyTorch version
// (repro_torch.kernels.ref.flash_attention_ref) runs the same recurrence
// over the same 64-key tiles, so the two differ only in float32 summation
// order (and, for bf16, where that moves p across a rounding boundary).
//
// Layout: q, k, v and out are addressed by element strides of (batch, seq,
// head) with unit stride along D -- the (B, S, H, D) layout the model's
// projections produce, taken without a transpose copy.
//
// Two kernels:
//   * bf16: mma.sync m16n8k16 (bf16 in, float32 accumulate) on the tensor
//     cores.  Four warps, 16 query rows each; the Q tile's fragments stay in
//     registers, K and V tiles (64 x D) are staged in shared memory with
//     16-byte loads, V's B-fragments come from ldmatrix.trans, and the
//     score fragments are re-packed as the A operand of p.v in registers.
//   * float32: the same recurrence on the CUDA cores (no tensor-core path
//     keeps float32 products exact): 256 threads, each owning a 4 x 4 block
//     of the 64 x 64 score tile and 4 x D/16 outputs; Q, K, V and p in
//     shared memory.
//
// What bounds it on the H100: operations.  At qwen2-0.5b's prefill (S =
// 4096, D = 64) a head reads 1.5 MB and does ~2 GFLOP of causal products,
// far above the 295 flop/byte the tensor cores need.  This simple form
// stays well above that bound: the tile loads are synchronous (no cp.async
// or TMA pipeline; several blocks per SM overlap them) and the products are
// mma.sync, not wgmma.  Variants with 128-row tiles or cp.async double
// buffering measured slower on the H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows per block, keys per tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

struct Strides {
  long long b, s, h;               // elements
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head into a (64, D + 8) shared tile
// with 16-byte loads; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long s_stride,
    int row0, int S) {
  constexpr int kChunks = D / 8;     // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, Strides sq, Strides sk,
                 Strides sv, Strides so, int S, int group, int causal,
                 float scale) {
  constexpr int kLd = D + 8;         // padded row: conflict-free fragments
  constexpr int kSteps = D / 16;     // k-steps of q.k^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTile * kLd;
  __nv_bfloat16* Vs = Ks + kTile * kLd;

  const int n_q = (S + kTile - 1) / kTile;
  const int iq = n_q - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = iq * kTile;
  const __nv_bfloat16* qh = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kh = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vh = v + b * sv.b + hk * sv.h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  const int r_lo = warp * 16 + g;         // tile rows this thread holds
  const int row_lo = q0 + r_lo, row_hi = row_lo + 8;

  load_tile_bf16<D>(Qs, qh, sq.s, q0, S);
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const __nv_bfloat16* base = Qs + r_lo * kLd + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int n_k = causal ? iq + 1 : n_q;
  for (int jk = 0; jk < n_k; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();                      // the last tile's readers are done
    load_tile_bf16<D>(Ks, kh, sk.s, k0, S);
    load_tile_bf16<D>(Vs, vh, sv.s, k0, S);
    __syncthreads();

    // s = q . k^T for this warp's 16 rows x 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const __nv_bfloat16* base = Ks + (nt * 8 + g) * kLd + kk * 16 + t * 2;
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(base),
                 *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }
    // scale, mask, row max (a row's 64 scores lie on the 4 lanes of a group);
    // only the diagonal tile and the ragged tail need the mask
    float mx[2] = {kNegInf, kNegInf};
    const bool edge = (causal && k0 + kTile - 1 > q0 + warp * 16) ||
                      k0 + kTile > S;
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (e < 2) ? row_lo : row_hi;
          const int col = k0 + nt * 8 + t * 2 + (e & 1);
          const bool ok = col < S && (!causal || col <= row);
          s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
    }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new[i]);
    }
    // p = exp(s - m') (0 where masked), packed as bf16 A fragments of p.v
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[nt][e] == kNegInf ? 0.f : expf(s[nt][e] - m_new[e >> 1]);
        sum[e >> 1] += p[e];
      }
      // keys nt*8.. of k-step nt/2: low half (a0, a1) or high half (a2, a3)
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
    // acc += p . v: V's B fragments by ldmatrix.trans, two d-tiles a load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        const int mat = lane / 8;         // this lane's row address feeds it
        const int key = kk * 16 + (mat & 1) * 8 + lane % 8;
        const int col = (nd + (mat >> 1)) * 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + key * kLd + col);
        mma_bf16(acc[nd], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[nd + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30), rows past S not written
  const float inv_lo = 1.f / fmaxf(l[0], 1e-30f);
  const float inv_hi = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* oh = out + b * so.b + h * so.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + t * 2;
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(oh + row_lo * so.s + col) =
          pack_bf16(acc[nd][0] * inv_lo, acc[nd][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(oh + row_hi * so.s + col) =
          pack_bf16(acc[nd][2] * inv_hi, acc[nd][3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 x 16: 4 x 4 scores per thread

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src,
                                              long long s_stride, int row0,
                                              int S) {
  constexpr int kChunks = D / 4;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kSimtThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      x = *reinterpret_cast<const float4*>(src + (row0 + r) * s_stride + c);
    float* d = dst + r * ld + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  Strides sq, Strides sk, Strides sv, Strides so, int S,
                  int group, int causal, float scale) {
  constexpr int kLd = D + 1;         // odd row stride: conflict-free columns
  constexpr int kPld = kTile + 1;
  constexpr int kCols = D / 16;      // output columns per thread
  extern __shared__ float smem_f[];
  float* Qs = smem_f;                // (64, D + 1)
  float* Ks = Qs + kTile * kLd;      // (64, D + 1)
  float* Vs = Ks + kTile * kLd;      // (64, D)
  float* Ps = Vs + kTile * D;        // (64, 65)

  const int n_q = (S + kTile - 1) / kTile;
  const int iq = n_q - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = iq * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // this thread's rows ty + 16 i and score columns tx + 16 j; the 16
  // threads of a row are 16 consecutive lanes of one warp

  load_tile_f32<D>(Qs, kLd, q + b * sq.b + h * sq.h, sq.s, q0, S);
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_k = causal ? iq + 1 : n_q;
  for (int jk = 0; jk < n_k; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();
    load_tile_f32<D>(Ks, kLd, k + b * sk.b + hk * sk.h, sk.s, k0, S);
    load_tile_f32<D>(Vs, D, v + b * sv.b + hk * sv.h, sv.s, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kPld + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* oh = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      oh[row * so.s + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             void* out, Strides sq, Strides sk, Strides sv, Strides so, int B,
             int S, int H, int group, int causal, float scale,
             cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  if (dtype == 0) {
    const size_t smem = 3 * kTile * (D + 8) * sizeof(__nv_bfloat16);
    cudaFuncSetAttribute(flash_mma_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), sq, sk, sv, so, S, group, causal,
        scale);
  } else {
    const size_t smem =
        (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1)) *
        sizeof(float);
    cudaFuncSetAttribute(flash_simt_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    flash_simt_kernel<D><<<grid, kSimtThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, sv,
        so, S, group, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: base pointers; each has element strides (batch, seq, head)
// and unit stride along D.  dtype 0 = bf16, 1 = float32; D in {32, 64,
// 128}.  Returns cudaGetLastError() after the launch (the wrapper checks
// shapes, strides and alignment before calling).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sob, long long sos, long long soh, int B, int S,
    int H, int Kh, int D, int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh != 0 ||
      (dtype != 0 && dtype != 1) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh},
      so{sob, sos, soh};
  const int group = H / Kh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(dtype, q, k, v, out, sq, sk, sv, so, B, S, H, group,
                          causal, scale, st);
    case 64:
      return launch_d<64>(dtype, q, k, v, out, sq, sk, sv, so, B, S, H, group,
                          causal, scale, st);
    case 128:
      return launch_d<128>(dtype, q, k, v, out, sq, sk, sv, so, B, S, H,
                           group, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
