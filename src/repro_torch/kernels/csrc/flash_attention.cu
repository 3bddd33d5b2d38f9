// flash_attention: causal (or full) grouped-query attention forward for
// NVIDIA Hopper (sm_90a), online softmax over key tiles.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).  There the grid's last dimension walks the key blocks in
// order on one core and carries the running max m, sum l and accumulator in
// VMEM scratch from one grid step to the next.  Blocks of a GPU run in no
// order, so here one block owns one (batch, head, query tile) and walks the
// key tiles itself, keeping m, l and the accumulator in registers:
//
//   s   = (q . k^T) * scale                       float32, scale = 1/sqrt(D)
//   s   = -1e30 where masked (causal: key > query; keys >= S)
//   m'  = max(m, rowmax(s));  p = exp(s - m') (0 where masked)
//   l   = l * exp(m - m') + rowsum(p)
//   acc = acc * exp(m - m') + p . v               p in float32
//   out = acc / max(l, 1e-30)                      a division, cast to q's dtype
//
// The TPU kernel casts q, k and v to float32 before any product
// (flash_attention.py:43-45), so p enters p.v in float32 and the one
// rounding to bf16 is the output's.  The bf16 tensor cores take p as two
// bf16 terms, hi = bf16(p) and lo = bf16(p - hi) (split_bf16), each
// multiplied by v into the float32 accumulator: p is kept to 2^-16
// relative.  Key tiles strictly after the query tile's last row are
// skipped (causal), and the longest query tiles start first.  Query head
// h reads key/value head h / (H / Kh).  Any S >= 1: rows and keys past S
// are masked, and a row with no unmasked key gives 0.  The plain PyTorch
// version (repro_torch.kernels.ref.flash_attention_ref) runs the same
// recurrence in float32 over 64-key tiles; the kernels differ from it in
// float32 summation order, tile width, the 2^-16 of p and (wgmma kernel)
// exp taken as ex2.approx of a scaled score, which moves a bf16 output
// across a rounding boundary now and then (<= 1 ulp).
//
// Layout: q, k, v and out are addressed by element strides of (batch, seq,
// head) with unit stride along D -- the (B, S, H, D) layout the model's
// projections produce, taken without a transpose copy.
//
// Three kernels, chosen by the wrapper (flash_attention.py, route()):
//   * bf16, D in {64, 128}: flash_wgmma_kernel.  One block of three
//     warpgroups per (batch, head, 128-row query tile).  A producer
//     warpgroup, shrunk by setmaxnreg, issues TMA copies (Q once, then K and
//     V tiles of 128 keys into a three-stage ring guarded by full and empty
//     mbarriers); two consumer warpgroups of 64 rows each, grown by
//     setmaxnreg, run S = Q.K^T as wgmma m64n128k16 from 128-byte swizzled
//     shared memory, the online softmax in registers, and O += P.V as wgmma
//     with P's hi and lo fragments in registers and V read MN-major through
//     the descriptor's transpose bit.  Each consumer issues S_j and
//     P_{j-1}.V_{j-1} together and runs S_j's softmax while they are in
//     flight.
//   * bf16, D = 32: flash_mma_kernel, mma.sync m16n8k16.  Four warps, 16
//     query rows each; the Q tile's fragments stay in registers, K and V
//     tiles (64 x D) are staged in shared memory with 16-byte loads, V's B
//     fragments come from ldmatrix.trans, and p's hi and lo fragments are
//     packed from the score fragments in registers.
//   * float32: flash_simt_kernel, the same recurrence on the CUDA cores (no
//     tensor-core path keeps float32 products exact): 256 threads, each
//     owning a 4 x 4 block of the 64 x 64 score tile and 4 x D/16 outputs;
//     Q, K, V and p in shared memory.
//
// What bounds it on the H100: operations.  At qwen2-0.5b's prefill (q (4,
// 14, 4096, 64), k and v (4, 2, 4096, 64), causal) the causal q.k^T is
// 60.15 GFLOP and p.v, as two bf16 products, 120.3: 0.182 ms at the bf16
// peak of 989 TFLOP/s, against 67 MB of q, k, v and out (0.020 ms).  Why
// the earlier pipelines lost (PERF.md): the mma.sync kernel overlaps its
// synchronous tile loads only through other blocks on the SM, and a
// cp.async double buffer raised it to 138 registers, so three blocks fit
// an SM where four did -- the pipeline cost a block of occupancy.  Here
// the pipeline runs inside one block: one thread issues whole-tile TMA
// copies, and the producer's registers go to the consumers.

#include <cuda.h>                  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>

namespace {

constexpr int kTile = 64;          // query rows per block, keys per tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.44269504088896341f;

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

// p (two float32 values) as hi = bf16(p) and lo = bf16(p - hi), packed
// pairs.  p - hi is exact in float32, so hi + lo holds p to a relative
// 2^-16 (one bf16 rounding: 2^-8).  Two terms, not three: a third,
// bf16(p - hi - lo), would make the product float32-exact at 1.5x the p.v
// work again, and two already keep >= 99 % of the bf16 outputs bit-equal
// to the float32-p plain version (PERF.md).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
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
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so, int S,
                 int group, int causal, float scale) {
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
    // p = exp(s - m') (0 where masked) in float32, split into the hi and
    // lo bf16 A fragments of p.v
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[nt][e] == kNegInf ? 0.f : expf(s[nt][e] - m_new[e >> 1]);
        sum[e >> 1] += p[e];
      }
      // keys nt*8.. of k-step nt/2: low half (a0, a1) or high half (a2, a3)
      split_bf16(p[0], p[1], ph[nt / 2][(nt % 2) * 2], pl[nt / 2][(nt % 2) * 2]);
      split_bf16(p[2], p[3], ph[nt / 2][(nt % 2) * 2 + 1],
                 pl[nt / 2][(nt % 2) * 2 + 1]);
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
    // acc += hi . v, then lo . v: V's B fragments by ldmatrix.trans, two
    // d-tiles a load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        const int mat = lane / 8;         // this lane's row address feeds it
        const int key = kk * 16 + (mat & 1) * 8 + lane % 8;
        const int col = (nd + (mat >> 1)) * 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + key * kLd + col);
        mma_bf16(acc[nd], ph[kk], vb[0], vb[1]);
        mma_bf16(acc[nd], pl[kk], vb[0], vb[1]);
        mma_bf16(acc[nd + 1], ph[kk], vb[2], vb[3]);
        mma_bf16(acc[nd + 1], pl[kk], vb[2], vb[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30), rows past S not written; lse = m + log(l)
  // (m holds scaled scores) when asked for
  const float l_lo = fmaxf(l[0], 1e-30f), l_hi = fmaxf(l[1], 1e-30f);
  if (lse != nullptr && t == 0) {
    float* lh = lse + (static_cast<long long>(b) * gridDim.y + h) * S;
    if (row_lo < S) lh[row_lo] = m[0] + logf(l[0]);
    if (row_hi < S) lh[row_hi] = m[1] + logf(l[1]);
  }
  __nv_bfloat16* oh = out + b * so.b + h * so.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + t * 2;
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(oh + row_lo * so.s + col) = pack_bf16(
          __fdiv_rn(acc[nd][0], l_lo), __fdiv_rn(acc[nd][1], l_lo));
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(oh + row_hi * so.s + col) = pack_bf16(
          __fdiv_rn(acc[nd][2], l_hi), __fdiv_rn(acc[nd][3], l_hi));
  }
}

// ---------------------------------------------------------------------------
// bf16, D in {64, 128}: wgmma on TMA-fed tiles, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;       // query rows per block, keys per tile
constexpr int kWgThreads = 384;    // one producer + two consumer warpgroups
constexpr int kStages = 3;         // K/V ring depth
constexpr int kHalf = kWgRows * 128;  // one 64-column half of a tile: 16 KB
constexpr int kConsumerWarps = 8;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): Q, then the K and V rings, each tile
// D / 64 halves of 128 rows x 64 columns, then the mbarriers.
template <int D>
struct WgLayout {
  static constexpr int kTile = (D / 64) * kHalf;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-column x 128-row box of a (B, S, heads, D) tensor into shared
// memory, 128-byte swizzled; rows past S arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B.  K-major (Q, K): stride = 1024 B between 8-row groups,
// leading unused.  MN-major (V): stride = 1024 B between 8-key groups,
// leading = the distance between 64-column halves.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes of wgmma
// operands across the asynchronous issue / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= a . b: a and b from shared memory, both K-major; m64n128k16.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a . b: a (4 registers of bf16 pairs) from registers, b MN-major
// from shared memory (the transpose bit); m64n64k16 and m64n128k16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_n64(o, a, b);
  else
    wgmma_rs_n128(o, a, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warpgroup's view of the tiles: its 64 query rows, the shared memory
// and the scale.  The score and P.V accumulators follow the wgmma layout:
// s[4j + e] is row (e < 2 ? row_lo : row_hi), key 8j + 2t + (e & 1) of
// the tile; o[4j + e] the same rows, column 8j + 2t + (e & 1).
template <int D>
struct Consumer {
  uint32_t q, k, v;                // shared addresses: this warpgroup's Q
                                   // rows, the K and V rings
  int q0, row_lo, row_hi, t, S, causal;
  float scale_log2;                // 1/sqrt(D) * log2(e)

  // s = q . k^T for the tile in stage st: D / 16 k-steps of m64n128k16
  __device__ __forceinline__ void issue_qk(float (&s)[64], int st) const {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
      wgmma_ss_n128(s, sw128_desc(q + off, 16, 1024),
                    sw128_desc(k + st * WgLayout<D>::kTile + off, 16, 1024),
                    kk > 0);
    }
    wg_commit();
  }

  // o += hi . v, then lo . v, for each 16-key step of the tile in stage st
  __device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                           const uint32_t (&ph)[8][4],
                                           const uint32_t (&pl)[8][4],
                                           int st) const {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = sw128_desc(
          v + st * WgLayout<D>::kTile + kk * 16 * 128, kHalf, 1024);
      wgmma_pv<D>(o, ph[kk], dv);
      wgmma_pv<D>(o, pl[kk], dv);
    }
    wg_commit();
  }

  // The online-softmax step on the score tile of keys k0..k0+127: mask
  // (only the diagonal tile and the ragged tail need it), the rows' new
  // maxima, corr = exp(m_old - m_new), l, and s replaced by p =
  // exp(s * scale - m_new) in float32.  exp(x) is ex2(x * log2(e)) with
  // the scale folded into one fma; m is kept unscaled (scaling is
  // monotonic, so the max is the same).  The edge test depends on the
  // block and the tile only, so every thread takes the same branch.
  __device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2],
                                          float (&l)[2], float (&corr)[2],
                                          int k0) const {
    const bool edge = (causal && k0 == q0) || k0 + kWgRows > S;
    float mx[2] = {kNegInf, kNegInf};
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int row = (i & 2) ? row_hi : row_lo;
        const int col = k0 + (i / 4) * 8 + t * 2 + (i & 1);
        s[i] = (col >= S || (causal && col > row)) ? kNegInf : s[i];
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
      mc[r] = m_new * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = ex2(fmaf(s[i], scale_log2, -mc[(i >> 1) & 1]));
      s[i] = (edge && s[i] == kNegInf) ? 0.f : p;
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
  }
};

// p (float32, in s) as the hi and lo bf16 A fragments of p.v: k-step kk
// holds keys 16kk.. as (a0, a1) from s[8kk..8kk+3] and (a2, a3) from
// s[8kk+4..8kk+7].
__device__ __forceinline__ void split_p(const float (&s)[64],
                                        uint32_t (&ph)[8][4],
                                        uint32_t (&pl)[8][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    split_bf16(s[4 * j], s[4 * j + 1], ph[j / 2][(j % 2) * 2],
               pl[j / 2][(j % 2) * 2]);
    split_bf16(s[4 * j + 2], s[4 * j + 3], ph[j / 2][(j % 2) * 2 + 1],
               pl[j / 2][(j % 2) * 2 + 1]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// One block per (batch, query head, 128-row query tile), flattened with
// the query tile slowest and reversed, so every head's longest tiles start
// first.  Warpgroup 0 produces: one thread loads the Q tile once, then K
// and V tiles of 128 keys into a ring of kStages stages (full / empty
// mbarriers).  Warpgroups 1 and 2 consume, 64 query rows each.  A
// consumer's step j issues S_j = Q.K_j^T and O += P_{j-1}.V_{j-1} together
// (wgmma, P as register A fragments: the score accumulator's layout is the
// A-operand layout, so p never touches shared memory), then runs the
// softmax of S_j while its products are in flight.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   Strides so, int S, int H, int B, int group, int causal,
                   float scale) {
  using L = WgLayout<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + kStages);

  const int n_q = (S + kWgRows - 1) / kWgRows;
  const int heads = H * B;
  const int iq = n_q - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % heads % H;
  const int b = static_cast<int>(blockIdx.x) % heads / H;
  const int hk = h / group, q0 = iq * kWgRows;
  const int n_k = causal ? iq + 1 : n_q;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: gives up registers; one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kTile);
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load(base + L::kQ + hf * kHalf, &tq, bar_q, hf * 64, q0, h, b);
      for (int jk = 0; jk < n_k; ++jk) {
        const int st = jk % kStages;
        // the first pass over the ring finds every stage free
        mbar_wait(bar_empty + 8 * st, ((jk / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kTile);
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(base + L::kK + st * L::kTile + hf * kHalf, &tk,
                   bar_full + 8 * st, hf * 64, jk * kWgRows, hk, b);
          tma_load(base + L::kV + st * L::kTile + hf * kHalf, &tv,
                   bar_full + 8 * st, hf * 64, jk * kWgRows, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / 128 - 1;          // consumer 0 or 1
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    Consumer<D> w;
    w.q = base + L::kQ + c * 64 * 128;
    w.k = base + L::kK;
    w.v = base + L::kV;
    w.q0 = q0;
    w.row_lo = q0 + c * 64 + warp * 16 + lane / 4;
    w.row_hi = w.row_lo + 8;
    w.t = lane % 4;
    w.S = S;
    w.causal = causal;
    w.scale_log2 = scale * kLog2e;

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[64];
    uint32_t ph[8][4], pl[8][4];

    mbar_wait(bar_q, 0);
    // step 0: S_0 only
    mbar_wait(bar_full, 0);
    wg_fence();
    w.issue_qk(s, 0);
    wg_wait<0>();
    fence_regs(s);
    w.softmax(s, m, l, corr, 0);
    split_p(s, ph, pl);
    fence_regs(ph);
    fence_regs(pl);
    // step j: S_j and P_{j-1}.V_{j-1}
    for (int jk = 1; jk < n_k; ++jk) {
      const int st = jk % kStages, prev = (jk - 1) % kStages;
      mbar_wait(bar_full + 8 * st, (jk / kStages) & 1);
      rescale<D>(o, corr);                        // to P_{j-1}'s maxima
      fence_regs(o);
      wg_fence();
      w.issue_qk(s, st);
      w.issue_pv(o, ph, pl, prev);
      wg_wait<1>();                               // S_j is in
      fence_regs(s);
      w.softmax(s, m, l, corr, jk * kWgRows);
      wg_wait<0>();                               // P_{j-1}.V_{j-1} is in
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);   // stage free
      split_p(s, ph, pl);
      fence_regs(ph);
      fence_regs(pl);
    }
    rescale<D>(o, corr);
    fence_regs(o);
    wg_fence();
    w.issue_pv(o, ph, pl, (n_k - 1) % kStages);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);

    // out = o / max(l, 1e-30), rows past S not written; lse = scale * m +
    // log(l) (m holds unscaled scores) when asked for
    const float l_lo = fmaxf(l[0], 1e-30f), l_hi = fmaxf(l[1], 1e-30f);
    if (lse != nullptr && w.t == 0) {
      float* lh = lse + (static_cast<long long>(b) * H + h) * S;
      if (w.row_lo < S) lh[w.row_lo] = fmaf(m[0], scale, logf(l[0]));
      if (w.row_hi < S) lh[w.row_hi] = fmaf(m[1], scale, logf(l[1]));
    }
    __nv_bfloat16* oh = out + b * so.b + h * so.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + w.t * 2;
      if (w.row_lo < S)
        *reinterpret_cast<uint32_t*>(oh + w.row_lo * so.s + col) = pack_bf16(
            __fdiv_rn(o[4 * j], l_lo), __fdiv_rn(o[4 * j + 1], l_lo));
      if (w.row_hi < S)
        *reinterpret_cast<uint32_t*>(oh + w.row_hi * so.s + col) = pack_bf16(
            __fdiv_rn(o[4 * j + 2], l_hi), __fdiv_rn(o[4 * j + 3], l_hi));
    }
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
                  float* __restrict__ lse, Strides sq, Strides sk,
                  Strides sv, Strides so, int S, int group, int causal,
                  float scale) {
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
    const float li = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)     // m holds scaled scores
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] =
          m[i] + logf(l[i]);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      oh[row * so.s + tx + 16 * j] = __fdiv_rn(acc[i][j], li);
  }
}

// ---------------------------------------------------------------------------
// backward: the gradient of the forward above (no TPU kernel: the JAX
// package trains through autodiff of its plain attention)
// ---------------------------------------------------------------------------
//
// FlashAttention-2's scheme, from the forward's float32 row log-sum-exp
// lse (B, H, S) and its output O:
//
//   delta = rowsum(dO o O)                           flash_bwd_delta_kernel
//   per key tile, over the live query tiles:         flash_bwd_dkdv_*_kernel
//     s  = q . k^T * scale;  p = exp(s - lse) (0 where masked)
//     dV += p^T . dO;  dp = dO . v^T;  ds = p o (dp - delta)
//     dK += ds^T . q                      (dK scaled once at the end)
//   per query tile, over the live key tiles:
//     dQ += ds . k (recomputing s, p, dp and ds)     flash_bwd_dq_*_kernel
//
// No float atomics: every gradient element is summed in a fixed order, so
// two launches give the same bits and a resumed training run equals a
// straight one.  That is why the dQ kernel recomputes s and dp rather than
// taking ds from the dK/dV kernel: the function needs five products, 10 D
// operations a live (query, key) pair, this design 14 D.  p and ds are
// rounded once to bf16 as the A operands of their products, every sum is
// float32; float32 runs the same recurrences on the CUDA cores.  Rows and
// keys at or past S are masked and never written.  What bounds it on the
// H100: operations, so the best this design can reach is 10 / 14 of the
// bound.
//
// Three routes, chosen by the wrapper (flash_attention.py, route(), the
// forward's rule):
//   * bf16, D in {64, 128}: wgmma fed by TMA, warp-specialised as the
//     forward (one producer warpgroup, two consumer warpgroups of 64 rows,
//     a kStages ring behind full and empty mbarriers), four launches.
//     flash_bwd_delta_kernel also writes lse * log2(e), each head's rows
//     padded to 64 (+inf past S, so that p = 0 there), for the TMA-fed
//     kernels.  flash_bwd_dq_wgmma_kernel: one block per (batch, head,
//     128-row query tile), Q and dO resident, 64-key K and V tiles
//     streamed.  flash_bwd_dkdv_wgmma_kernel: one block per (batch, query
//     head, 128-key tile), K and V resident, the live 64-row Q and dO
//     tiles streamed with their lse and delta rows; s^T = K.Q^T and dp^T
//     = V.dO^T are the A fragments of dV += p^T.dO and dK += ds^T.Q (dO
//     and Q read MN-major).  A block owns one query head, so a GQA
//     group's G heads write float32 partials that flash_bwd_gsum_kernel
//     adds in head order (G = 1 writes bf16 directly).  At qwen2-0.5b's
//     training shape (q (4, 14, 2048, 64), causal) the dK/dV kernel's 896
//     blocks walk 2 to 32 tiles, the longest first, against an even share
//     of 115 on 132 SMs (the dQ kernel's 896 alike: 2 to 32 key tiles);
//     the old schedule, a block per (KV head, key tile) over the group's 7
//     heads, walked 7 to 224 against 28.
//   * bf16, D = 32: mma.sync m16n8k16 (a 64-byte row is narrower than the
//     128-byte swizzle), four warps a block, three launches; the dK/dV
//     block owns a (batch, kv head, 64-key tile) and loops over the
//     group's heads.
//   * float32: the CUDA cores, the same schedule as D = 32.
//
// Measured at the training shape (PERF.md, kernel table; chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W): ~0.31 ms a call against the
// 0.076 ms bound, under bf16 SDPA's backward (~0.39 ms) in the same run,
// where the mma.sync design took 0.98: delta ~0.015, dQ ~0.105, dK/dV
// ~0.155, the group sum ~0.023.  The two wgmma kernels run their 14 D at
// ~42 % of the bf16 peak: a consumer waits on its own products between
// the exponentials.  Tried and not kept (PERF.md): queueing the next
// tile's s^T and dp^T behind this tile's dV and dK (no accumulator
// written but by wgmma, each fenced where it is zeroed, else ptxas
// serialises the products, C7515) took 0.010 ms off at D = 64 but ran
// the D = 128 dK/dV kernel out of registers (C7512), 10 % slower; 128-row
// tiles (the dK/dV kernel's ran out of registers; the dQ kernel's changed
// nothing beyond the noise); a ring of 2 or 4 stages.

constexpr int kDeltaThreads = 256;

// 16 bytes of a row of x times the same of y, added to acc in order.
__device__ __forceinline__ float dot16(const float* x, const float* y,
                                       float acc) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(y);
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* x,
                                       const __nv_bfloat16* y, float acc) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const uint4 b = *reinterpret_cast<const uint4*>(y);
  const uint32_t as[4] = {a.x, a.y, a.z, a.w}, bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&as[i]));
    const float2 fb =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bs[i]));
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// Lanes a row of the delta pass: 16-byte loads, at most 8 lanes a row, so
// a warp reads whole rows of 128 bytes or more.
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  return D * static_cast<int>(sizeof(T)) / 16 < 8
             ? D * static_cast<int>(sizeof(T)) / 16 : 8;
}

// delta[row] = sum_d dO[row, d] * O[row, d] in float32, rows in (b, h, s)
// order, s_pad rows a head, delta_lanes() lanes a row.  Given lse2 (the
// wgmma route, s_pad = S rounded up to 64), it also writes lse2[row] = lse
// * log2(e), and rows at or past S get delta 0 and lse2 +inf, so that
// exp2(s - lse2) is 0 there.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ lse2,
                       Strides so, Strides sdo, int S, int s_pad, int H,
                       long long rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kLanes = delta_lanes<T, D>();
  const int sub = threadIdx.x % kLanes;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDeltaThreads / kLanes) + threadIdx.x / kLanes;
  const int s = static_cast<int>(row % s_pad);
  const long long bh = row / s_pad;
  float acc = 0.f;
  if (row < rows && s < S) {
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const T* orow = o + b * so.b + h * so.h + s * so.s;
    const T* drow = dout + b * sdo.b + h * sdo.h + s * sdo.s;
#pragma unroll
    for (int i = sub * kVec; i < D; i += kLanes * kVec)
      acc = dot16(drow + i, orow + i, acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row >= rows || sub != 0) return;
  delta[row] = acc;
  if (lse2 != nullptr)
    lse2[row] = s < S ? lse[bh * S + s] * kLog2e : __int_as_float(0x7f800000);
}

// Blocks of the delta pass over rows.
template <typename T, int D>
long long delta_blocks(long long rows) {
  constexpr int per = kDeltaThreads / delta_lanes<T, D>();
  return (rows + per - 1) / per;
}

// bf16: tensor cores.  Four warps, 16 rows of a 64-row tile each.

// c[nt] = rows r, r + 8 of tile a . rows nt * 8 + g of tile b, over D: a
// 16 x 64 product of two (64, D + 8) row-major shared tiles, in the score
// fragment layout (c[nt][e]: row e < 2 ? r : r + 8, column nt * 8 + 2t +
// (e & 1)).
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&c)[8][4],
                                              const __nv_bfloat16* a,
                                              const __nv_bfloat16* b, int r,
                                              int g, int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* pa = a + r * kLd + kk * 16 + 2 * t;
    uint32_t fa[4];
    fa[0] = *reinterpret_cast<const uint32_t*>(pa);
    fa[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * kLd);
    fa[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
    fa[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * kLd + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* pb = b + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
      mma_bf16(c[nt], fa, *reinterpret_cast<const uint32_t*>(pb),
               *reinterpret_cast<const uint32_t*>(pb + 8));
    }
  }
}

// acc (16 rows x D) += x . m: x the 16 x 64 float32 values of a score
// fragment (rounded once to bf16 as A fragments), m a (64, D + 8)
// row-major shared tile whose rows are the contraction, its B fragments by
// ldmatrix.trans, two d-tiles a load.
template <int D>
__device__ __forceinline__ void frags_dot_tile(float (&acc)[D / 8][4],
                                               const float (&x)[8][4],
                                               const __nv_bfloat16* m,
                                               int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      const int mat = lane / 8;
      const int row = kk * 16 + (mat & 1) * 8 + lane % 8;
      const int col = (nd + (mat >> 1)) * 8;
      uint32_t mb[4];
      ldmatrix_x4_trans(mb, m + row * kLd + col);
      mma_bf16(acc[nd], a, mb[0], mb[1]);
      mma_bf16(acc[nd + 1], a, mb[2], mb[3]);
    }
  }
}

// Rows r, r + 8 of a (rows, D) gradient: acc * scale as bf16, rows past S
// not written.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                long long s_stride,
                                                const float (&acc)[D / 8][4],
                                                int row_lo, int t, int S,
                                                float scale) {
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + t * 2;
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(dst + row_lo * s_stride + col) =
          pack_bf16(acc[nd][0] * scale, acc[nd][1] * scale);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(dst + row_hi * s_stride + col) =
          pack_bf16(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

// One block per (64-key tile, kv head, batch); key tile 0, the longest
// under the causal mask, first.  Shared: K, V, then each query tile's Q,
// dO, lse and delta.  A warp's rows are keys: s^T = K . Q^T and dp^T =
// V . dO^T, so p^T and ds^T are the A fragments of dV += p^T . dO and
// dK += ds^T . Q without a transpose.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdk, Strides sdv, int S, int H, int group,
    int causal, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * kLd;
  __nv_bfloat16* Qs = Vs + kTile * kLd;
  __nv_bfloat16* Ds = Qs + kTile * kLd;            // dO
  float* Ls = reinterpret_cast<float*>(Ds + kTile * kLd);
  float* Es = Ls + kTile;                          // delta

  const int n_t = (S + kTile - 1) / kTile;
  const int jk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = jk * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = warp * 16 + g;                     // tile rows r, r + 8
  const int key_lo = k0 + r, key_hi = key_lo + 8;

  load_tile_bf16<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
  load_tile_bf16<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const __nv_bfloat16* qh = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* doh = dout + b * sdo.b + h * sdo.h;
    const float* lh = lse + (static_cast<long long>(b) * H + h) * S;
    const float* eh = delta + (static_cast<long long>(b) * H + h) * S;
    for (int iq = causal ? jk : 0; iq < n_t; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();                   // the last tile's readers are done
      load_tile_bf16<D>(Qs, qh, sq.s, q0, S);
      load_tile_bf16<D>(Ds, doh, sdo.s, q0, S);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < S ? lh[row] : 0.f;
        Es[threadIdx.x] = row < S ? eh[row] : 0.f;
      }
      __syncthreads();
      float st[8][4], dpt[8][4];
      rows_dot_rows<D>(st, Ks, Qs, r, g, t);       // s^T: keys x queries
      rows_dot_rows<D>(dpt, Vs, Ds, r, g, t);      // dp^T
      const bool edge =
          (causal && iq == jk) || q0 + kTile > S || k0 + kTile > S;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cq = nt * 8 + 2 * t + (e & 1);  // query in the tile
          const int key = (e < 2) ? key_lo : key_hi;
          const bool ok = !edge || (q0 + cq < S && key < S &&
                                    (!causal || key <= q0 + cq));
          const float p = ok ? expf(fmaf(st[nt][e], scale, -Ls[cq])) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - Es[cq]);
        }
      }
      frags_dot_tile<D>(dva, st, Ds, lane);        // dV += p^T . dO
      frags_dot_tile<D>(dka, dpt, Qs, lane);       // dK += ds^T . Q
    }
  }
  store_rows_bf16<D>(dk + b * sdk.b + hk * sdk.h, sdk.s, dka, key_lo, t, S,
                     scale);
  store_rows_bf16<D>(dv + b * sdv.b + hk * sdv.h, sdv.s, dva, key_lo, t, S,
                     1.f);
}

// One block per (64-row query tile, head, batch), the longest tiles first.
// Shared: Q and dO, then each key tile's K and V.  A warp's rows are
// queries, as in the forward; ds is the A fragment of dQ += ds . K.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int S,
    int group, int causal, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ds = Qs + kTile * kLd;            // dO
  __nv_bfloat16* Ks = Ds + kTile * kLd;
  __nv_bfloat16* Vs = Ks + kTile * kLd;

  const int n_t = (S + kTile - 1) / kTile;
  const int iq = n_t - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = iq * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = warp * 16 + g;
  const int row_lo = q0 + r, row_hi = row_lo + 8;

  load_tile_bf16<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile_bf16<D>(Ds, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  const long long bh = (static_cast<long long>(b) * gridDim.y + h) * S;
  const float l_lo = row_lo < S ? lse[bh + row_lo] : 0.f;
  const float l_hi = row_hi < S ? lse[bh + row_hi] : 0.f;
  const float e_lo = row_lo < S ? delta[bh + row_lo] : 0.f;
  const float e_hi = row_hi < S ? delta[bh + row_hi] : 0.f;
  float dqa[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    dqa[nd][0] = dqa[nd][1] = dqa[nd][2] = dqa[nd][3] = 0.f;

  const int n_k = causal ? iq + 1 : n_t;
  for (int jk = 0; jk < n_k; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();                     // the last tile's readers are done
    load_tile_bf16<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
    load_tile_bf16<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);
    __syncthreads();
    float s[8][4], dp[8][4];
    rows_dot_rows<D>(s, Qs, Ks, r, g, t);
    rows_dot_rows<D>(dp, Ds, Vs, r, g, t);
    const bool edge =
        (causal && jk == iq) || k0 + kTile > S || q0 + kTile > S;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e < 2) ? row_lo : row_hi;
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok =
            !edge || (row < S && key < S && (!causal || key <= row));
        const float p =
            ok ? expf(fmaf(s[nt][e], scale, -((e < 2) ? l_lo : l_hi))) : 0.f;
        s[nt][e] = p * (dp[nt][e] - ((e < 2) ? e_lo : e_hi));     // ds
      }
    }
    frags_dot_tile<D>(dqa, s, Ks, lane);           // dQ += ds . K
  }
  store_rows_bf16<D>(dq + b * sdq.b + h * sdq.h, sdq.s, dqa, row_lo, t, S,
                     scale);
}

// bf16, D in {64, 128}: wgmma on TMA-fed tiles, warp-specialised (the
// forward's producer, ring and register split).

constexpr int kBwdRows = 64;               // rows of a streamed tile
constexpr int kBwdHalf = kBwdRows * 128;   // its 64-column half: 8 KB

// Shared memory of both backward kernels, from a 1024-byte aligned base:
// a resident pair of 128-row tiles (K and V, or Q and dO), a ring of
// kStages pairs of streamed 64-row tiles (Q and dO, or K and V), the
// ring's lse2 and delta rows (64 floats each; the dK/dV kernel's), then
// the mbarriers.  A tile is D / 64 halves of its rows x 64 columns, each
// loaded as 64-row TMA boxes, 128-byte swizzled.
template <int D>
struct BwdLayout {
  static constexpr int kRes = (D / 64) * kHalf;        // 128 rows
  static constexpr int kTile = (D / 64) * kBwdHalf;    // 64 rows
  static constexpr int kResA = 0;
  static constexpr int kResB = kRes;
  static constexpr int kRingA = 2 * kRes;
  static constexpr int kRingB = kRingA + kStages * kTile;
  static constexpr int kRows = kRingB + kStages * kTile;
  static constexpr int kBar = kRows + kStages * 2 * kBwdRows * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// d (+)= a . b: a and b from shared memory, both K-major; m64n64k16.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// bytes (a multiple of 16) from 16-byte aligned global memory into shared
// memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// `boxes` 64-row TMA boxes from row0 of one head into a tile whose halves
// are half_bytes apart.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, int half_bytes,
                                          const CUtensorMap* map,
                                          uint32_t bar, int row0, int boxes,
                                          int head, int batch) {
  for (int hf = 0; hf < D / 64; ++hf)
    for (int r = 0; r < boxes; ++r)
      tma_load(dst + hf * half_bytes + r * kBwdHalf, map, bar, hf * 64,
               row0 + r * kBwdRows, head, batch);
}

// x = a . b^T over D: a the consumer's 64 rows of a resident 128-row tile,
// b a 64-row ring tile, both K-major; D / 16 k-steps of m64n64k16.  x[4j +
// e] is a's row (e < 2 ? lo : lo + 8), b's row 8j + 2t + (e & 1).
template <int D>
__device__ __forceinline__ void issue_rows_dot(float (&x)[32], uint32_t a,
                                               uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(x, sw128_desc(a + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024),
                 sw128_desc(b + (kk / 4) * kBwdHalf + (kk % 4) * 32, 16, 1024),
                 kk > 0);
}

// acc += f . m: f the bf16 A fragments of 64 contraction rows (k-step kk
// holds rows 16kk..16kk + 15), m a 64-row ring tile read MN-major.
template <int D>
__device__ __forceinline__ void issue_frags_dot(float (&acc)[D / 2],
                                                const uint32_t (&f)[4][4],
                                                uint32_t m) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<D>(acc, f[kk], sw128_desc(m + kk * 16 * 128, kBwdHalf, 1024));
}

// Four float32 values of an accumulator's group j as two bf16 A-fragment
// registers of k-step j / 2 (split_p's layout, one term).
__device__ __forceinline__ void put_frag(uint32_t (&f)[4][4], int j,
                                         const float (&v)[4]) {
  f[j / 2][(j % 2) * 2] = pack_bf16(v[0], v[1]);
  f[j / 2][(j % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// Rows lo, lo + 8 of an m64nD accumulator (acc[4j + e]: row e < 2 ? lo :
// lo + 8, column 8j + 2t + (e & 1)) times scale as bf16; rows past S not
// written.
template <int D>
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* dst,
                                               long long s_stride,
                                               const float (&acc)[D / 2],
                                               int lo, int t, int S,
                                               float scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (lo < S)
      *reinterpret_cast<uint32_t*>(dst + lo * s_stride + col) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (lo + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (lo + 8) * s_stride + col) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// The same rows as float32 into a contiguous (rows, D) array.
template <int D>
__device__ __forceinline__ void store_acc_f32(float* dst,
                                              const float (&acc)[D / 2],
                                              int lo, int t, int S) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (lo < S)
      *reinterpret_cast<float2*>(dst + static_cast<long long>(lo) * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (lo + 8 < S)
      *reinterpret_cast<float2*>(dst + static_cast<long long>(lo + 8) * D +
                                 col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// p^T = exp2(s^T * scale * log2(e) - lse2[query]), in place in x (the
// dK/dV kernel's tile: rows keys key_lo, key_lo + 8, columns queries q0 +
// 8j + 2t + (e & 1)), and its bf16 A fragments; kMask zeroes the keys past
// their query (the tiles that meet the diagonal).
template <bool kMask>
__device__ __forceinline__ void p_cols(float (&x)[32], uint32_t (&pf)[4][4],
                                       const float* l2, float scale_log2,
                                       int key_lo, int q0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lj = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(x[4 * j + e], scale_log2, -((e & 1) ? lj.y : lj.x)));
      if (kMask && key_lo + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1))
        p[e] = 0.f;
      x[4 * j + e] = p[e];
    }
    put_frag(pf, j, p);
  }
}

// p = exp2(s * scale * log2(e) - lse2[row]), in place in x (the dQ
// kernel's tile: rows row_lo, row_lo + 8 with lse2 lr, columns keys k0 +
// 8j + 2t + (e & 1)); kMask zeroes the keys at or past S and, when
// causal, past their row.
template <bool kMask>
__device__ __forceinline__ void p_rows(float (&x)[32], const float (&lr)[2],
                                       float scale_log2, int row_lo, int k0,
                                       int t, int S, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = ex2(fmaf(x[4 * j + e], scale_log2, -lr[e >> 1]));
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      const int row = row_lo + 8 * (e >> 1);
      x[4 * j + e] =
          kMask && (key >= S || (causal && key > row)) ? 0.f : v;
    }
  }
}

// One block per (batch, query head, 128-key tile), flattened with the key
// tile slowest, so that key tile 0, the longest under the causal mask,
// starts first.  Warpgroup 0 produces: one thread loads the block's K and
// V once, then the head's live 64-row Q and dO tiles with their lse2 and
// delta rows into the ring.  Warpgroups 1 and 2 consume, 64 keys each:
// s^T = K.Q^T and dp^T = V.dO^T (two commit groups, so that p^T's
// exponentials run while dp^T is in flight), then dV += p^T.dO and dK +=
// ds^T.Q with p^T and ds^T as register A fragments.  With a GQA group (H >
// Kh) the block writes its head's float32 partials of dK and dV to part
// ((B, H, S, D) each, dK's first) for flash_bwd_gsum_kernel; without (part
// null) it writes dK (scaled) and dV.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse2,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ part, Strides sdk,
                            Strides sdv, int S, int H, int B, int group,
                            int causal, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t bar_res = base + L::kBar;
  const uint32_t bar_full = bar_res + 8;
  const uint32_t bar_empty = bar_res + 8 * (1 + kStages);

  const int s_pad = (S + kBwdRows - 1) / kBwdRows * kBwdRows;
  const int n_q = s_pad / kBwdRows;
  const int heads = H * B;
  const int jk = static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % heads % H;
  const int b = static_cast<int>(blockIdx.x) % heads / H;
  const int hk = h / group, k0 = jk * kWgRows;
  const int iq0 = causal ? k0 / kBwdRows : 0;     // the first live query tile
  const long long bh = static_cast<long long>(b) * H + h;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_res, 2 * L::kRes);
      load_rows<D>(base + L::kResA, kHalf, &tk, bar_res, k0, 2, hk, b);
      load_rows<D>(base + L::kResB, kHalf, &tv, bar_res, k0, 2, hk, b);
      const float* l2 = lse2 + bh * s_pad;
      const float* dl = delta + bh * s_pad;
      for (int i = 0; iq0 + i < n_q; ++i) {
        const int st = i % kStages, q0 = (iq0 + i) * kBwdRows;
        const uint32_t full = bar_full + 8 * st;
        const uint32_t rows = base + L::kRows + st * 2 * kBwdRows * 4;
        // the first pass over the ring finds every stage free
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTile + 2 * kBwdRows * 4);
        load_rows<D>(base + L::kRingA + st * L::kTile, kBwdHalf, &tq, full,
                     q0, 1, h, b);
        load_rows<D>(base + L::kRingB + st * L::kTile, kBwdHalf, &tdo, full,
                     q0, 1, h, b);
        bulk_load(rows, l2 + q0, kBwdRows * 4, full);
        bulk_load(rows + kBwdRows * 4, dl + q0, kBwdRows * 4, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;          // consumer 0 or 1
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int key_lo = k0 + c * 64 + warp * 16 + lane / 4;  // and key_lo + 8
    const float scale_log2 = scale * kLog2e;
    const uint32_t ka = base + L::kResA + c * kBwdHalf;
    const uint32_t va = base + L::kResB + c * kBwdHalf;
    float dva[D / 2], dka[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;
    float x[32], y[32];
    uint32_t pf[4][4], df[4][4];

    mbar_wait(bar_res, 0);
    for (int i = 0; iq0 + i < n_q; ++i) {
      const int st = i % kStages, q0 = (iq0 + i) * kBwdRows;
      const uint32_t qt = base + L::kRingA + st * L::kTile;
      const uint32_t dot = base + L::kRingB + st * L::kTile;
      const float* l2 = rows_s + st * 2 * kBwdRows;
      const float* dl = l2 + kBwdRows;
      // only the tiles that meet the diagonal need the causal mask; query
      // rows past S have lse2 = +inf, so p = 0 there without one
      const bool edge = causal && q0 < k0 + kWgRows;
      mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
      wg_fence();
      issue_rows_dot<D>(x, ka, qt);               // s^T = K . Q^T
      wg_commit();
      issue_rows_dot<D>(y, va, dot);              // dp^T = V . dO^T
      wg_commit();
      wg_wait<1>();                               // s^T is in
      fence_regs(x);
      if (edge)
        p_cols<true>(x, pf, l2, scale_log2, key_lo, q0, t);
      else
        p_cols<false>(x, pf, l2, scale_log2, key_lo, q0, t);
      fence_regs(pf);
      wg_fence();
      issue_frags_dot<D>(dva, pf, dot);           // dV += p^T . dO
      wg_commit();
      wg_wait<1>();                               // dp^T is in
      fence_regs(y);
      // ds^T = p^T o (dp^T - delta[query])
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
        float g[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          g[e] = x[4 * j + e] * (y[4 * j + e] - ((e & 1) ? dj.y : dj.x));
        put_frag(df, j, g);
      }
      fence_regs(df);
      wg_fence();
      issue_frags_dot<D>(dka, df, qt);            // dK += ds^T . Q
      wg_commit();
      wg_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pf);
      fence_regs(df);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // stage free
    }

    if (part == nullptr) {
      store_acc_bf16<D>(dk + b * sdk.b + hk * sdk.h, sdk.s, dka, key_lo, t, S,
                        scale);
      store_acc_bf16<D>(dv + b * sdv.b + hk * sdv.h, sdv.s, dva, key_lo, t, S,
                        1.f);
    } else {
      float* pk = part + bh * S * D;
      store_acc_f32<D>(pk, dka, key_lo, t, S);
      store_acc_f32<D>(pk + static_cast<long long>(heads) * S * D, dva, key_lo,
                       t, S);
    }
  }
}

// One block per (batch, head, 128-row query tile), the longest tiles first
// as in the forward.  Warpgroup 0 produces: one thread loads the block's Q
// and dO once, then the live 64-key K and V tiles into the ring.
// Warpgroups 1 and 2 consume, 64 rows each: s = Q.K^T and dp = dO.V^T
// (two commit groups), ds in registers, then dQ += ds.K with K read
// MN-major.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, Strides sdq, int S,
                          int H, int B, int group, int causal, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_res = base + L::kBar;
  const uint32_t bar_full = bar_res + 8;
  const uint32_t bar_empty = bar_res + 8 * (1 + kStages);

  const int s_pad = (S + kBwdRows - 1) / kBwdRows * kBwdRows;
  const int n_t = s_pad / kBwdRows;                 // 64-key tiles
  const int n_q = (S + kWgRows - 1) / kWgRows;      // 128-row query tiles
  const int heads = H * B;
  const int iq = n_q - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % heads % H;
  const int b = static_cast<int>(blockIdx.x) % heads / H;
  const int hk = h / group, q0 = iq * kWgRows;
  const int n_k = causal ? min(n_t, 2 * iq + 2) : n_t;
  const long long bh = static_cast<long long>(b) * H + h;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_res, 2 * L::kRes);
      load_rows<D>(base + L::kResA, kHalf, &tq, bar_res, q0, 2, h, b);
      load_rows<D>(base + L::kResB, kHalf, &tdo, bar_res, q0, 2, h, b);
      for (int jk = 0; jk < n_k; ++jk) {
        const int st = jk % kStages;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((jk / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTile);
        load_rows<D>(base + L::kRingA + st * L::kTile, kBwdHalf, &tk, full,
                     jk * kBwdRows, 1, hk, b);
        load_rows<D>(base + L::kRingB + st * L::kTile, kBwdHalf, &tv, full,
                     jk * kBwdRows, 1, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row_lo = q0 + c * 64 + warp * 16 + lane / 4;   // and row_lo + 8
    const float scale_log2 = scale * kLog2e;
    const uint32_t qa = base + L::kResA + c * kBwdHalf;
    const uint32_t oa = base + L::kResB + c * kBwdHalf;
    const float* l2 = lse2 + bh * s_pad;
    const float* dl = delta + bh * s_pad;
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      lr[r] = row < S ? l2[row] : __int_as_float(0x7f800000);
      dr[r] = row < S ? dl[row] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    float x[32], y[32];
    uint32_t df[4][4];

    mbar_wait(bar_res, 0);
    for (int jk = 0; jk < n_k; ++jk) {
      const int st = jk % kStages, k0 = jk * kBwdRows;
      const uint32_t kt = base + L::kRingA + st * L::kTile;
      const uint32_t vt = base + L::kRingB + st * L::kTile;
      // the diagonal tiles and the ragged last one need the mask
      const bool edge = (causal && k0 >= q0) || k0 + kBwdRows > S;
      mbar_wait(bar_full + 8 * st, (jk / kStages) & 1);
      wg_fence();
      issue_rows_dot<D>(x, qa, kt);               // s = Q . K^T
      wg_commit();
      issue_rows_dot<D>(y, oa, vt);               // dp = dO . V^T
      wg_commit();
      wg_wait<1>();                               // s is in
      fence_regs(x);
      if (edge)
        p_rows<true>(x, lr, scale_log2, row_lo, k0, t, S, causal);
      else
        p_rows<false>(x, lr, scale_log2, row_lo, k0, t, S, causal);
      wg_wait<0>();                               // dp is in
      fence_regs(y);
      // ds = p o (dp - delta[row])
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float g[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          g[e] = x[4 * j + e] * (y[4 * j + e] - dr[e >> 1]);
        put_frag(df, j, g);
      }
      fence_regs(df);
      wg_fence();
      issue_frags_dot<D>(dqa, df, kt);            // dQ += ds . K
      wg_commit();
      wg_wait<0>();
      fence_regs(dqa);
      fence_regs(df);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // stage free
    }
    store_acc_bf16<D>(dq + b * sdq.b + h * sdq.h, sdq.s, dqa, row_lo, t, S,
                      scale);
  }
}

// dK and dV of each KV head from its group's float32 partials (B, H, S, D)
// (dK's, then dV's, plane elements on), added in head order h = hk * G,
// ..., hk * G + G - 1, so that every launch gives the same bits; dK scaled,
// both written as bf16.  Four columns a thread; blockIdx.y picks dK (0) or
// dV (1).
__global__ void __launch_bounds__(256)
flash_bwd_gsum_kernel(const float* __restrict__ part,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Strides sdk,
                      Strides sdv, int S, int H, int Kh, int D,
                      long long quads, long long plane, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= quads) return;
  const bool is_v = blockIdx.y == 1;
  const int group = H / Kh;
  const int d = static_cast<int>(i * 4 % D);
  const long long r = i * 4 / D;                  // (b, hk, s) rows
  const int s = static_cast<int>(r % S);
  const long long bk = r / S;
  const int hk = static_cast<int>(bk % Kh), b = static_cast<int>(bk / Kh);
  const long long row = (static_cast<long long>(b) * H + hk * group) * S + s;
  const float* src = part + (is_v ? plane : 0) + row * D + d;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < group; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(
        src + static_cast<long long>(g) * S * D);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float m = is_v ? 1.f : scale;
  __nv_bfloat16* dst =
      is_v ? dv + b * sdv.b + hk * sdv.h + s * sdv.s + d
           : dk + b * sdk.b + hk * sdk.h + s * sdk.s + d;
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      pack_bf16(acc.x * m, acc.y * m), pack_bf16(acc.z * m, acc.w * m));
}

// float32: CUDA cores, 256 threads as 16 x 16, each owning 4 x 4 of the
// 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and 4 x D / 16 of
// its gradient rows (columns tx + 16 c).

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dkdv_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, int S, int H,
    int group, int causal, float scale) {
  constexpr int kLd = D + 1;         // odd row stride: conflict-free columns
  constexpr int kPld = kTile + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;                // (64, D + 1) each
  float* Vs = Ks + kTile * kLd;
  float* Qs = Vs + kTile * kLd;
  float* Ds = Qs + kTile * kLd;      // dO
  float* Ps = Ds + kTile * kLd;      // p^T (64 keys, 65)
  float* Gs = Ps + kTile * kPld;     // ds^T
  float* Ls = Gs + kTile * kPld;     // lse of the query tile
  float* Es = Ls + kTile;            // delta

  const int n_t = (S + kTile - 1) / kTile;
  const int jk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = jk * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_f32<D>(Ks, kLd, k + b * sk.b + hk * sk.h, sk.s, k0, S);
  load_tile_f32<D>(Vs, kLd, v + b * sv.b + hk * sv.h, sv.s, k0, S);
  float dka[4][kCols], dva[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const float* lh = lse + (static_cast<long long>(b) * H + h) * S;
    const float* eh = delta + (static_cast<long long>(b) * H + h) * S;
    for (int iq = causal ? jk : 0; iq < n_t; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();
      load_tile_f32<D>(Qs, kLd, q + b * sq.b + h * sq.h, sq.s, q0, S);
      load_tile_f32<D>(Ds, kLd, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < S ? lh[row] : 0.f;
        Es[threadIdx.x] = row < S ? eh[row] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * kLd + d];
          vv[i] = Vs[(ty + 16 * i) * kLd + d];
          qv[i] = Qs[(tx + 16 * i) * kLd + d];
          ov[i] = Ds[(tx + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cq = tx + 16 * j, row = q0 + cq;
          const bool ok = row < S && key < S && (!causal || key <= row);
          const float p = ok ? expf(fmaf(st[i][j], scale, -Ls[cq])) : 0.f;
          Ps[(ty + 16 * i) * kPld + cq] = p;
          Gs[(ty + 16 * i) * kPld + cq] = p * (dpt[i][j] - Es[cq]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kTile; ++c) {
        float pv[4], gv[4], ov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * kPld + c];
          gv[i] = Gs[(ty + 16 * i) * kPld + c];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          ov[j] = Ds[c * kLd + tx + 16 * j];
          qv[j] = Qs[c * kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
            dka[i][j] = fmaf(gv[i], qv[j], dka[i][j]);
          }
      }
    }
  }
  float* dkh = dk + b * sdk.b + hk * sdk.h;
  float* dvh = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dkh[key * sdk.s + tx + 16 * j] = dka[i][j] * scale;
      dvh[key * sdv.s + tx + 16 * j] = dva[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dq_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdq, int S, int group, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kTile + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;                // (64, D + 1) each
  float* Ds = Qs + kTile * kLd;      // dO
  float* Ks = Ds + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Gs = Vs + kTile * kLd;      // ds (64 rows, 65)

  const int n_t = (S + kTile - 1) / kTile;
  const int iq = n_t - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = iq * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile_f32<D>(Qs, kLd, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile_f32<D>(Ds, kLd, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  const long long bh = (static_cast<long long>(b) * gridDim.y + h) * S;
  float lr[4], er[4], dqa[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < S ? lse[bh + row] : 0.f;
    er[i] = row < S ? delta[bh + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqa[i][c] = 0.f;
  }

  const int n_k = causal ? iq + 1 : n_t;
  for (int jk = 0; jk < n_k; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();
    load_tile_f32<D>(Ks, kLd, k + b * sk.b + hk * sk.h, sk.s, k0, S);
    load_tile_f32<D>(Vs, kLd, v + b * sv.b + hk * sv.h, sv.s, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * kLd + d];
        ov[i] = Ds[(ty + 16 * i) * kLd + d];
        kv[i] = Ks[(tx + 16 * i) * kLd + d];
        vv[i] = Vs[(tx + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = row < S && key < S && (!causal || key <= row);
        const float p = ok ? expf(fmaf(s[i][j], scale, -lr[i])) : 0.f;
        Gs[(ty + 16 * i) * kPld + tx + 16 * j] = p * (dp[i][j] - er[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float gv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = Gs[(ty + 16 * i) * kPld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          dqa[i][j] = fmaf(gv[i], kv[j], dqa[i][j]);
    }
  }
  float* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dqh[row * sdq.s + tx + 16 * j] = dqa[i][j] * scale;
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, S, H, Kh, causal;
  float scale;
};

int tensor_map(CUtensorMap* map, const void* base, Strides st, int B, int S,
               int heads, int D, int rows);

// The wgmma backward kernels' dynamic shared memory, set once per device
// (a bit each) and width: a training step makes 24 calls, and the host,
// not the card, binds much of it.
template <int D>
int bwd_wgmma_smem(int smem) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return 0;
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

// The wgmma route's launches, each checked: delta (with lse2, padded to
// 64 rows, into scratch), dQ, dK/dV, and with a GQA group the partials'
// sum (scratch after lse2).  The tensor maps are encoded while the delta
// pass runs.
template <int D>
int launch_bwd_wgmma(const BwdArgs& a, float* scratch, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int group = a.H / a.Kh;
  const int s_pad = (a.S + kBwdRows - 1) / kBwdRows * kBwdRows;
  const long long rows = static_cast<long long>(a.B) * a.H * s_pad;
  const long long d_blocks = delta_blocks<bf, D>(rows);
  const long long blocks =
      static_cast<long long>((a.S + kWgRows - 1) / kWgRows) * a.H * a.B;
  const long long quads = static_cast<long long>(a.B) * a.Kh * a.S * D / 4;
  if (d_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL ||
      (quads + 255) / 256 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse2 = scratch;
  float* part = group > 1 ? scratch + rows : nullptr;
  const int smem = BwdLayout<D>::kBytes;
  int err = bwd_wgmma_smem<D>(smem);
  if (err != 0) return err;
  flash_bwd_delta_kernel<bf, D>
      <<<static_cast<unsigned>(d_blocks), kDeltaThreads, 0, stream>>>(
          static_cast<const bf*>(a.o), static_cast<const bf*>(a.dout), a.lse,
          a.delta, lse2, a.so, a.sdo, a.S, s_pad, a.H, rows);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  CUtensorMap tq, tk, tv, tdo;
  err = tensor_map(&tq, a.q, a.sq, a.B, a.S, a.H, D, kBwdRows);
  if (err == 0) err = tensor_map(&tk, a.k, a.sk, a.B, a.S, a.Kh, D, kBwdRows);
  if (err == 0) err = tensor_map(&tv, a.v, a.sv, a.B, a.S, a.Kh, D, kBwdRows);
  if (err == 0)
    err = tensor_map(&tdo, a.dout, a.sdo, a.B, a.S, a.H, D, kBwdRows);
  if (err != 0) return err;
  flash_bwd_dq_wgmma_kernel<D>
      <<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
          tq, tk, tv, tdo, lse2, a.delta, static_cast<bf*>(a.dq), a.sdq, a.S,
          a.H, a.B, group, a.causal, a.scale);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
          tq, tk, tv, tdo, lse2, a.delta, static_cast<bf*>(a.dk),
          static_cast<bf*>(a.dv), part, a.sdk, a.sdv, a.S, a.H, a.B, group,
          a.causal, a.scale);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  if (part != nullptr)
    flash_bwd_gsum_kernel<<<dim3(static_cast<unsigned>((quads + 255) / 256),
                                 2),
                            256, 0, stream>>>(
        part, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.sdk, a.sdv,
        a.S, a.H, a.Kh, D, quads,
        static_cast<long long>(a.B) * a.H * a.S * D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The launches of one backward, each checked; kernel 0 = bf16 on mma.sync
// (D = 32), 1 = float32 on the CUDA cores, 2 = bf16 on wgmma + TMA (D in
// {64, 128}).
template <int D>
int launch_bwd_d(int kernel, const BwdArgs& a, float* scratch,
                 cudaStream_t stream) {
  const int group = a.H / a.Kh;
  const int n_t = (a.S + kTile - 1) / kTile;
  const long long rows = static_cast<long long>(a.B) * a.H * a.S;
  if (delta_blocks<float, D>(rows) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 kv_grid(n_t, a.Kh, a.B), q_grid(n_t, a.H, a.B);
  int err;
  if (kernel == 1) {
    flash_bwd_delta_kernel<float, D>
        <<<static_cast<unsigned>(delta_blocks<float, D>(rows)), kDeltaThreads,
           0, stream>>>(
            static_cast<const float*>(a.o), static_cast<const float*>(a.dout),
            nullptr, a.delta, nullptr, a.so, a.sdo, a.S, a.S, a.H, rows);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    const int smem_kv = (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) +
                         2 * kTile) * static_cast<int>(sizeof(float));
    const int smem_q = (4 * kTile * (D + 1) + kTile * (kTile + 1)) *
                       static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(flash_bwd_dkdv_simt_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_kv);
    cudaFuncSetAttribute(flash_bwd_dq_simt_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    flash_bwd_dkdv_simt_kernel<D><<<kv_grid, kSimtThreads, smem_kv, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.S, a.H, group, a.causal,
        a.scale);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    flash_bwd_dq_simt_kernel<D><<<q_grid, kSimtThreads, smem_q, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo,
        a.sdq, a.S, group, a.causal, a.scale);
  } else if constexpr (D == 32) {
    if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
    using bf = __nv_bfloat16;
    flash_bwd_delta_kernel<bf, D>
        <<<static_cast<unsigned>(delta_blocks<bf, D>(rows)), kDeltaThreads, 0,
           stream>>>(
            static_cast<const bf*>(a.o), static_cast<const bf*>(a.dout),
            nullptr, a.delta, nullptr, a.so, a.sdo, a.S, a.S, a.H, rows);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    const int smem_q = 4 * kTile * (D + 8) * static_cast<int>(sizeof(bf));
    const int smem_kv = smem_q + 2 * kTile * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_kv);
    cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    flash_bwd_dkdv_mma_kernel<D><<<kv_grid, kMmaThreads, smem_kv, stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
        a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.sq, a.sk,
        a.sv, a.sdo, a.sdk, a.sdv, a.S, a.H, group, a.causal, a.scale);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    flash_bwd_dq_mma_kernel<D><<<q_grid, kMmaThreads, smem_q, stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
        a.delta, static_cast<bf*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.S,
        group, a.causal, a.scale);
  } else {
    if (kernel != 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bwd_wgmma<D>(a, scratch, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

constexpr int kErrNoEncoder = 100001;   // the driver has no tensor maps
constexpr int kErrTensorMap = 100002;   // the layout was refused

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-d map of a (batch, seq, head, D) bf16 tensor given by element
// strides: boxes of 64 columns x `rows` rows of one head, 128-byte
// swizzled, rows past S filled with zeros.
int tensor_map(CUtensorMap* map, const void* base, Strides st, int B, int S,
               int heads, int D, int rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, Strides sq, Strides sk, Strides sv, Strides so,
                 int B, int S, int H, int Kh, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, sq, B, S, H, D, kWgRows);
  if (err == 0) err = tensor_map(&tk, k, sk, B, S, Kh, D, kWgRows);
  if (err == 0) err = tensor_map(&tv, v, sv, B, S, Kh, D, kWgRows);
  if (err != 0) return err;
  const long long blocks =
      static_cast<long long>((S + kWgRows - 1) / kWgRows) * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = WgLayout<D>::kBytes;
  cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  flash_wgmma_kernel<D><<<static_cast<unsigned>(blocks), kWgThreads, smem,
                          stream>>>(tq, tk, tv,
                                    static_cast<__nv_bfloat16*>(out), lse,
                                    so, S, H, B, H / Kh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int kernel, const void* q, const void* k, const void* v,
             void* out, float* lse, Strides sq, Strides sk, Strides sv,
             Strides so, int B, int S, int H, int Kh, int causal, float scale,
             cudaStream_t stream) {
  const int group = H / Kh;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  if (kernel == 1) {
    const size_t smem =
        (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1)) *
        sizeof(float);
    cudaFuncSetAttribute(flash_simt_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    flash_simt_kernel<D><<<grid, kSimtThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk,
        sv, so, S, group, causal, scale);
  } else if constexpr (D == 32) {
    if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 3 * kTile * (D + 8) * sizeof(__nv_bfloat16);
    cudaFuncSetAttribute(flash_mma_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    flash_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, sq, sk, sv, so, S, group,
        causal, scale);
  } else {
    if (kernel != 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<D>(q, k, v, out, lse, sq, sk, sv, so, B, S, H, Kh,
                           scale, causal, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: base pointers; each has element strides (batch, seq, head)
// and unit stride along D.  kernel 0 = bf16 on mma.sync (D = 32), 1 =
// float32 on the CUDA cores, 2 = bf16 on wgmma + TMA (D in {64, 128}); D
// in {32, 64, 128}, and another kernel for a D is an invalid value.  lse,
// when not null, receives the float32 row log-sum-exp of the scaled
// scores, a contiguous (B, H, S) array, for the backward; it is the last
// argument, so a caller of a library without it passes none.  Returns
// cudaGetLastError() after the launch, or an error of its own (the
// wrapper checks shapes, strides and alignment before calling).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int kernel,
    long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sob, long long sos, long long soh, int B, int S,
    int H, int Kh, int D, int causal, float scale, void* stream,
    float* lse) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh != 0 || kernel < 0 ||
      kernel > 2 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh},
      so{sob, sos, soh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(kernel, q, k, v, out, lse, sq, sk, sv, so, B, S, H,
                          Kh, causal, scale, st);
    case 64:
      return launch_d<64>(kernel, q, k, v, out, lse, sq, sk, sv, so, B, S, H,
                          Kh, causal, scale, st);
    case 128:
      return launch_d<128>(kernel, q, k, v, out, lse, sq, sk, sv, so, B, S,
                           H, Kh, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  if (err == kErrNoEncoder)
    return "the driver offers no cuTensorMapEncodeTiled";
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused the tensor's layout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The backward of one forward: q, k, v, o (the forward's output), dout
// (its gradient), lse (the forward's row log-sum-exp, a contiguous
// (B, H, S) float32 array) in; delta, a contiguous float32 scratch of
// (B, H, S) rows (kernel 2: (B, H, S_pad), S_pad = S rounded up to 64);
// dq, dk, dv out, in the inputs' dtype.  Each of the eight tensors has
// element strides (batch, seq, head) and unit stride along D.  kernel 0 =
// bf16 on mma.sync (D = 32), 1 = float32 on the CUDA cores (D in {32, 64,
// 128}), 2 = bf16 on wgmma + TMA (D in {64, 128}); another kernel for a D
// is an invalid value.  scratch, the last argument (kernel 2 only, else
// unused): B * H * S_pad floats, then, when H > Kh, 2 * B * H * S * D
// floats of partial dK and dV.  Returns the first launch's error, or 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int kernel, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, long long sob, long long sos,
    long long soh, long long sdob, long long sdos, long long sdoh,
    long long sdqb, long long sdqs, long long sdqh, long long sdkb,
    long long sdks, long long sdkh, long long sdvb, long long sdvs,
    long long sdvh, int B, int S, int H, int Kh, int D, int causal,
    float scale, void* stream, float* scratch) {
  if (B < 1 || S < 1 || H < 1 || Kh < 1 || H % Kh != 0 || kernel < 0 ||
      kernel > 2 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
                  Strides{sqb, sqs, sqh}, Strides{skb, sks, skh},
                  Strides{svb, svs, svh}, Strides{sob, sos, soh},
                  Strides{sdob, sdos, sdoh}, Strides{sdqb, sdqs, sdqh},
                  Strides{sdkb, sdks, sdkh}, Strides{sdvb, sdvs, sdvh},
                  B, S, H, Kh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_bwd_d<32>(kernel, a, scratch, st);
    case 64:
      return launch_bwd_d<64>(kernel, a, scratch, st);
    case 128:
      return launch_bwd_d<128>(kernel, a, scratch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
