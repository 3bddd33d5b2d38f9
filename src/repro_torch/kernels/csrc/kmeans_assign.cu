// kmeans_assign: fused K-means assignment and partial statistics for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/kmeans_assign.py::kmeans_assign
// (_km_kernel), which walks point blocks in order on one core, computes
// |c|^2 - 2 x.c^T on the MXU, takes the argmin and accumulates one-hot
// matmul partials in VMEM scratch.  Here every lane (vDPU) of a batch is
// one column of the grid and its rows are cut into chunks, one chunk per
// block:
//
//   d[r, k]   = |c_k|^2 - 2 * sum_j x[r, j] c[k, j]       (+|x_r|^2)
//   a[r]      = argmin_k d[r, k]     (first index on ties, as jnp.argmin)
//   sums[k,j] = sum_r w[r] x[r, j] [a[r] == k]
//   counts[k] = sum_r w[r] [a[r] == k]
//   sse       = sum_r w[r] (d[r, a[r]] + |x_r|^2)
//
// Rows are float32, int16 or int8 as they lie in the resident copy; an
// int row is dequantized in registers (one int->float conversion and one
// __fmul_rn by its feature's scale, which is exactly X.float() * scale).
//
// A block is up to eight warps that share the centroids and nothing else
// until they add up their partials at the end: warp v takes rows v*32 ..
// v*32 + 31 of each 256-row round of the block's chunk, one row a thread,
// in two phases:
//
//  1. Distances.  A thread reads its row as 16-byte vectors where the
//     rows' base, strides and width allow (else element by element: a
//     variant chosen by a rule on the shape), keeps it in registers (D <=
//     32; wider rows are dequantized into shared memory) and reads each
//     centroid as float4 broadcasts from shared memory.  x.c and |c|^2
//     are summed over j = 0..D-1 in order with __fmul_rn/__fadd_rn, so
//     nvcc cannot contract them into FMAs, and d = |c|^2 - 2 x.c with
//     __fsub_rn; the plain version (repro_torch.kernels.ref.
//     kmeans_assign_ref) does the same elementwise in the same order, so
//     assignments (and counts, of the path's 0/1 weights) are bit-equal to
//     it.  Rows are zero-padded to the register width, and adding 0 * 0 to
//     a sum that starts at +0 changes no bit.  The thread stages its row
//     in the warp's shared memory as float4 quads, (x_0 .. x_{D-1}, zero
//     pad, 1, |x - c_a|^2, 0, 0), with its assignment and weight.
//  2. Statistics.  The warp's threads form G groups of Q = ceil(D/4) + 1
//     (at most 32; beyond, a thread takes quads q, q + 32, ...):
//     thread (g, q) owns quad q of its group's partial statistics, a
//     (K, Q) float4 array in shared memory, and for the 32 rows t = g,
//     g + G, ... adds w_t * quad q of row t to cell (a_t, q).  So every
//     row is added once (sums, then the count and the sse of its cluster
//     in the last quad), no two threads write one word and no float
//     atomic is needed.  Before any group has added more than kFlushRows
//     rows, the warp adds its groups' partials into its own partial in a
//     fixed order (four interleaved sums over g) and zeroes them.
//
// The warps wait only on themselves (__syncwarp), so one warp's loads
// overlap the others' arithmetic.  At the end the block adds its warps'
// partials in warp order and writes them, and a second kernel adds the
// blocks' partials of each lane in block order, then the K clusters' sse
// terms (eight interleaved sums).  Two launches on the same input give the
// same bits.
//
// Rounding.  A term of a cell passes at most 1 (w * x; none for 0/1
// weights) + kFlushRows (its group's chain) + ceil(G/4) + 3 (the groups'
// sum and the flush) + F (the warp's flushes, at most one a round) + W
// (the warps) + B (the blocks) roundings, so a cell is within that many
// ulps of its mass (sum of w * |x|), and the sse within ceil(K/8) + 3
// more.  At the path's shapes (K = 8, D = 16: G = 5, F = 4 in a
// 4,096-row block, W = 8, B = 16) that is 1 + 32 + 5 + 4 + 8 + 16 = 66
// ulps for a sum and 70 for the sse, where the parent's serial tile sums
// allowed 1 + 64 + 2 + 16 + 16 = 99; at K = 64 (G = 1, F = 16) 77 and 88.
// One running sum over a block's rows would allow thousands (and int8
// rows, which repeat values, drift that way).  Counts of 0/1 weights are
// exact in any order.
//
// What bounds it on the H100: each row is read once (32 B at int16 x
// D = 16: the byte bound is 0.18 ms at 2^24 rows), but the distances'
// K * D multiplies and adds stay apart (no FMA, so that assignments stay
// bit-equal): with |x|^2, the dequantization, the argmin, staging and the
// statistics a warp issues about 21 instructions a row, 0.38 ms at the
// card's issue rate, and the loads' and the statistics' latencies are
// only partly hidden by the 32 warps an SM (shared memory, ~54 KB at the
// path's shapes, and 64 registers keep four blocks an SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // most threads a block; 32 a warp
constexpr int kWarpRows = 32;   // rows a warp takes at a time, one a thread
// rows each group adds to a cell between two flushes
constexpr int kFlushRows = 32;
// dynamic shared memory a block aims at: four blocks of an SM's 228 KB,
// less the 1 KB the system keeps for each; and what a block may take
constexpr long long kTargetWords = 57344 / 4;
constexpr long long kMaxWords = 232448 / 4;

// Register width of a row (8, 16, 32) or 0 (the row stays in shared
// memory).
inline int reg_width(int D) {
  return D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 0;
}

// A block's warps and each warp's statistics groups, and the block's
// shared memory in float32 words (kernels/kmeans_assign.py::layout
// mirrors it): per warp its staged rows, its groups' partials, its own
// partial, weights and assignments; then the centroids, scales and |c|^2.
struct Layout {
  int dq, q, qs, cstride, kq, warps, groups;
  long long words;
};

inline Layout layout(int K, int D) {
  Layout l;
  l.dq = (D + 3) / 4;
  l.q = l.dq + 1;
  l.qs = l.q | 1;                       // odd row stride in quads
  const int max_d = reg_width(D);
  l.cstride = max_d > 0 ? max_d : 4 * l.dq;
  l.kq = K * l.q;
  const long long fixed =
      static_cast<long long>(K + 1) * l.cstride + ((K + 3) & ~3);
  const long long per_warp = 4LL * (kWarpRows * l.qs + l.kq) + 2 * kWarpRows;
  const long long per_group = 4LL * (l.kq + 1);
  const int most = kWarpRows / (l.q < kWarpRows ? l.q : kWarpRows);
  for (l.warps = kThreads / 32; l.warps > 1; l.warps /= 2)
    if (fixed + l.warps * (per_warp + per_group) <= kMaxWords) break;
  long long g = (kTargetWords - fixed - l.warps * per_warp) /
                (l.warps * per_group);
  g = g < most ? g : most;
  l.groups = static_cast<int>(g < 1 ? 1 : g);
  l.words = fixed + l.warps * (per_warp + l.groups * per_group);
  return l;
}

__device__ __forceinline__ float4 axpy4(float4 s, float w, float4 x) {
  s.x = __fadd_rn(s.x, __fmul_rn(w, x.x));
  s.y = __fadd_rn(s.y, __fmul_rn(w, x.y));
  s.z = __fadd_rn(s.z, __fmul_rn(w, x.z));
  s.w = __fadd_rn(s.w, __fmul_rn(w, x.w));
  return s;
}

__device__ __forceinline__ float dot4(float s, float4 x, float4 c) {
  s = __fadd_rn(s, __fmul_rn(x.x, c.x));
  s = __fadd_rn(s, __fmul_rn(x.y, c.y));
  s = __fadd_rn(s, __fmul_rn(x.z, c.z));
  return __fadd_rn(s, __fmul_rn(x.w, c.w));
}

// A row's first kN elements as they lie in memory, zeros from D on.
template <typename T, int kN>
struct alignas(16) RawRow {
  T e[kN];
};

// Fetch a row: 16-byte loads where kVec (D * sizeof(T) is a multiple of
// 16 and the row is aligned), else one load an element.
template <typename T, bool kVec, int kN>
__device__ __forceinline__ void fetch_row(const T* __restrict__ xr, int D,
                                          RawRow<T, kN>& raw) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if constexpr (kVec && kN >= kPer) {
    int4* dst = reinterpret_cast<int4*>(raw.e);
#pragma unroll
    for (int b = 0; b < kN / kPer; ++b)
      dst[b] = b * kPer < D ? __ldg(reinterpret_cast<const int4*>(xr) + b)
                            : make_int4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) raw.e[j] = j < D ? xr[j] : T(0);
  }
}

// A fetched row dequantized: one conversion and one __fmul_rn by the
// feature's scale (float4 broadcasts from shared memory, zero from D on).
template <typename T, int kN>
__device__ __forceinline__ void dequantize(const RawRow<T, kN>& raw,
                                           const float4* sc, float* v) {
#pragma unroll
  for (int u = 0; u < kN / 4; ++u) {
    const float4 s = sc[u];
    v[4 * u] = __fmul_rn(static_cast<float>(raw.e[4 * u]), s.x);
    v[4 * u + 1] = __fmul_rn(static_cast<float>(raw.e[4 * u + 1]), s.y);
    v[4 * u + 2] = __fmul_rn(static_cast<float>(raw.e[4 * u + 2]), s.z);
    v[4 * u + 3] = __fmul_rn(static_cast<float>(raw.e[4 * u + 3]), s.w);
  }
}

template <typename T, int kMaxD, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
km_partials(const T* __restrict__ x, long long sxl, long long sxr,
            const float* __restrict__ c, long long scl,
            const float* __restrict__ w, long long swl, long long swr,
            const float* __restrict__ scale, long long R, int D, int K,
            long long rows_per_block, int groups,
            float* __restrict__ part, int* __restrict__ assign,
            long long sal) {
  const int dq = (D + 3) / 4, Q = dq + 1, qs = Q | 1;
  const int cstride = kMaxD > 0 ? kMaxD : 4 * dq;
  const int kq = K * Q;
  const int n_warps = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, wt = tid % 32;
  // this warp's staged rows, its groups' partials, its own partial
  const int per_warp = kWarpRows * qs + (groups + 1) * kq + groups;
  extern __shared__ float4 sm4[];
  float4* xs = sm4 + warp * per_warp;
  float4* accg = xs + kWarpRows * qs;           // groups * (kq + 1)
  float4* wsum = accg + groups * (kq + 1);      // kq
  float* cs = reinterpret_cast<float*>(sm4 + n_warps * per_warp);
  float* sc = cs + K * cstride;                 // cstride scales
  float* c2 = sc + cstride;                     // K |c|^2
  float* ws = c2 + ((K + 3) & ~3) + warp * 2 * kWarpRows;  // the warp's
  int* as = reinterpret_cast<int*>(ws + kWarpRows);        // rows' w, a
  const float4* sc4 = reinterpret_cast<const float4*>(sc);
  float* accf = reinterpret_cast<float*>(accg);
  float* wsumf = reinterpret_cast<float*>(wsum);
  const int gstride = 4 * (kq + 1);             // floats between groups

  const long long lane = blockIdx.y;
  const float* cl = c + lane * scl;
  for (int i = tid; i < K * cstride; i += blockDim.x) {
    const int k = i / cstride, j = i - k * cstride;
    cs[i] = j < D ? cl[k * D + j] : 0.0f;
  }
  for (int j = tid; j < cstride; j += blockDim.x)
    sc[j] = j < D ? (scale != nullptr ? scale[j] : 1.0f) : 0.0f;
  for (int i = wt; i < 4 * (groups * (kq + 1) + kq); i += 32)
    accf[i] = 0.0f;                             // the groups' and wsum
  __syncthreads();
  for (int k = tid; k < K; k += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < D; ++j)
      s = __fadd_rn(s, __fmul_rn(cs[k * cstride + j], cs[k * cstride + j]));
    c2[k] = s;
  }
  __syncthreads();

  // the statistics' thread (g, q) of this warp, of groups of up to 32
  // threads (quads q, q + 32, ... where Q > 32), and its group's partial
  const int span = Q < kWarpRows ? Q : kWarpRows;
  const int g = wt / span, q = wt - g * span;
  float4* mine = accg + g * (kq + 1);
  // the warp's groups' partials into its own partial, in group order
  // (four interleaved sums), then zeroed
  auto flush = [&]() {
    __syncwarp();
    for (int i = wt; i < 4 * kq; i += 32) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int h0 = 0; h0 < groups; h0 += 4) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          if (h0 + h < groups) {
            float* a = accf + (h0 + h) * gstride + i;
            s[h] = __fadd_rn(s[h], *a);
            *a = 0.0f;
          }
        }
      }
      wsumf[i] = __fadd_rn(wsumf[i], __fadd_rn(__fadd_rn(s[0], s[1]),
                                               __fadd_rn(s[2], s[3])));
    }
    __syncwarp();
  };

  const T* xl = x + lane * sxl;
  const float* wl = w + lane * swl;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long row_end =
      row0 + rows_per_block < R ? row0 + rows_per_block : R;
  const int per_tile = (kWarpRows + groups - 1) / groups;   // rows a group
  int pend = 0;          // rows each group has added since the last flush
  // the warps take turns through the block's rows, 32 at a time
  for (long long base = row0 + warp * kWarpRows; base < row_end;
       base += n_warps * kWarpRows) {
    const long long r = base + wt;
    const bool here = r < row_end;
    // 1. distances: a row a thread, staged as quads
    float4* row = xs + wt * qs;
    float x2 = 0.0f, best = 0.0f, wv = 0.0f;
    int arg = 0;
    if constexpr (kMaxD > 0) {
      RawRow<T, kMaxD> raw;
      fetch_row<T, kVec, kMaxD>(xl + r * sxr, here ? D : 0, raw);
      wv = here ? wl[r * swr] : 0.0f;
      float v[kMaxD];
      dequantize<T, kMaxD>(raw, sc4, v);
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        x2 = __fadd_rn(x2, __fmul_rn(v[j], v[j]));
      for (int k = 0; k < K; ++k) {
        const float4* ck = reinterpret_cast<const float4*>(cs + k * kMaxD);
        float dot = 0.0f;
#pragma unroll
        for (int u = 0; u < kMaxD / 4; ++u)
          dot = dot4(dot, make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2],
                                      v[4 * u + 3]), ck[u]);
        const float d = __fsub_rn(c2[k], __fmul_rn(2.0f, dot));
        if (k == 0 || d < best) {
          best = d;
          arg = k;
        }
      }
#pragma unroll
      for (int u = 0; u < kMaxD / 4; ++u)
        if (u < dq)
          row[u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2],
                               v[4 * u + 3]);
    } else if (here) {              // wide rows: dequantized in shared memory
      float* rowf = reinterpret_cast<float*>(row);
      const T* xr = xl + r * sxr;
      wv = wl[r * swr];
      constexpr int kPer = 16 / static_cast<int>(sizeof(T));
      if constexpr (kVec) {
        for (int b = 0; b < D / kPer; ++b) {
          RawRow<T, kPer> e;
          fetch_row<T, true, kPer>(xr + b * kPer, kPer, e);
          dequantize<T, kPer>(e, sc4 + b * kPer / 4, rowf + b * kPer);
        }
      } else {
        for (int j = 0; j < D; ++j)
          rowf[j] = __fmul_rn(static_cast<float>(xr[j]), sc[j]);
      }
      for (int j = D; j < 4 * dq; ++j) rowf[j] = 0.0f;
      for (int u = 0; u < dq; ++u) x2 = dot4(x2, row[u], row[u]);
      for (int k = 0; k < K; ++k) {
        const float4* ck = reinterpret_cast<const float4*>(cs + k * cstride);
        float dot = 0.0f;
        for (int u = 0; u < dq; ++u) dot = dot4(dot, row[u], ck[u]);
        const float d = __fsub_rn(c2[k], __fmul_rn(2.0f, dot));
        if (k == 0 || d < best) {
          best = d;
          arg = k;
        }
      }
    }
    if (here) {
      row[dq] = make_float4(1.0f, __fadd_rn(best, x2), 0.0f, 0.0f);
      ws[wt] = wv;
      as[wt] = arg;
      if (assign != nullptr) assign[lane * sal + r] = arg;
    }
    __syncwarp();
    // 2. statistics: group g adds rows g, g + G, ... of the 32
    const int n_here = static_cast<int>(
        row_end - base < kWarpRows ? row_end - base : kWarpRows);
    if (g < groups) {
      for (int t = g; t < n_here; t += groups) {
        float4* cells = mine + as[t] * Q;
        for (int u = q; u < Q; u += span)
          cells[u] = axpy4(cells[u], ws[t], xs[t * qs + u]);
      }
    }
    pend += per_tile;
    if (pend + per_tile > kFlushRows) {
      flush();
      pend = 0;
    }
    __syncwarp();
  }
  if (pend > 0) flush();
  __syncthreads();
  // the block's partial: its warps' partials added in warp order
  float* out = part + (lane * gridDim.x + blockIdx.x) * (4LL * kq);
  const float* w0 = reinterpret_cast<const float*>(sm4 + kWarpRows * qs +
                                                   groups * (kq + 1));
  for (int i = tid; i < 4 * kq; i += blockDim.x) {
    float s = 0.0f;
    for (int v = 0; v < n_warps; ++v)
      s = __fadd_rn(s, w0[4LL * v * per_warp + i]);
    out[i] = s;
  }
}

// One block per lane: add the lane's block partials in block order; the
// sse is the clusters' sse terms, in eight interleaved sums over k.
__global__ void __launch_bounds__(kThreads)
km_reduce(const float* __restrict__ part, int n_blocks, int D, int K,
          float* __restrict__ sums, float* __restrict__ counts,
          float* __restrict__ sse) {
  const int dq = (D + 3) / 4, Q = dq + 1;
  const long long cells = 4LL * K * Q;
  const long long lane = blockIdx.x;
  const float* p = part + lane * n_blocks * cells;
  auto over_blocks = [&](long long cell) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s = __fadd_rn(s, p[b * cells + cell]);
    return s;
  };
  for (int o = threadIdx.x; o < K * (D + 1) + 1; o += kThreads) {
    if (o < K * D) {
      const int k = o / D, j = o - k * D;
      sums[lane * K * D + o] = over_blocks(4LL * k * Q + j);
    } else if (o < K * D + K) {
      const int k = o - K * D;
      counts[lane * K + k] = over_blocks(4LL * k * Q + 4 * dq);
    } else {
      float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < K; k0 += 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (k0 + i < K)
            s[i] = __fadd_rn(s[i],
                             over_blocks(4LL * (k0 + i) * Q + 4 * dq + 1));
      }
      sse[lane] = __fadd_rn(
          __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3])),
          __fadd_rn(__fadd_rn(s[4], s[5]), __fadd_rn(s[6], s[7])));
    }
  }
}

template <typename T, int kMaxD, bool kVec>
cudaError_t launch_at(dim3 grid, const Layout& l, cudaStream_t stream,
                      const void* x, long long sxl, long long sxr,
                      const float* c, long long scl, const float* w,
                      long long swl, long long swr, const float* scale,
                      long long R, int D, int K, long long rows, float* part,
                      int* assign, long long sal) {
  auto kernel = km_partials<T, kMaxD, kVec>;
  const int smem = static_cast<int>(l.words * 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * l.warps, smem, stream>>>(
      static_cast<const T*>(x), sxl, sxr, c, scl, w, swl, swr, scale, R, D,
      K, rows, l.groups, part, assign, sal);
  return cudaGetLastError();
}

// The kernel for a shape: register width by D, and 16-byte row loads
// where the base, both strides and the row's width are multiples of 16
// bytes.
template <typename T>
cudaError_t launch_partials(dim3 grid, const Layout& l, cudaStream_t stream,
                            const void* x, long long sxl, long long sxr,
                            const float* c, long long scl, const float* w,
                            long long swl, long long swr, const float* scale,
                            long long R, int D, int K, long long rows,
                            float* part, int* assign, long long sal) {
  const long long es = static_cast<long long>(sizeof(T));
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (sxl * es) % 16 == 0 && (sxr * es) % 16 == 0 &&
                   (D * es) % 16 == 0;
  const int max_d = reg_width(D);
  auto at = max_d == 8    ? (vec ? launch_at<T, 8, true>
                                 : launch_at<T, 8, false>)
            : max_d == 16 ? (vec ? launch_at<T, 16, true>
                                 : launch_at<T, 16, false>)
            : max_d == 32 ? (vec ? launch_at<T, 32, true>
                                 : launch_at<T, 32, false>)
                          : (vec ? launch_at<T, 0, true>
                                 : launch_at<T, 0, false>);
  return at(grid, l, stream, x, sxl, sxr, c, scl, w, swl, swr, scale, R, D,
            K, rows, part, assign, sal);
}

}  // namespace

// x: (L, R, D) with unit stride along D; x_dtype 0 float32, 1 int16,
// 2 int8.  c: (K, D) contiguous per lane, lane stride scl (0 = shared).
// w: (L, R) float32.  scale: (D,) float32 or null (no dequantization).
// part: scratch of L * max_blocks * 4 * K * (ceil(D/4) + 1) float32.
// Outputs sums (L, K, D), counts (L, K), sse (L,), contiguous; assign
// (L, R) int32 with lane stride sal, or null.  Returns cudaGetLastError()
// after the launches.
extern "C" int kmeans_assign_launch(
    const void* x, int x_dtype, long long sxl, long long sxr, const void* c,
    long long scl, const void* w, long long swl, long long swr,
    const void* scale, int L, long long R, int D, int K, int max_blocks,
    void* part, void* sums, void* counts, void* sse, void* assign,
    long long sal, void* stream) {
  if (L < 1 || L > 65535 || R < 1 || D < 1 || K < 1 || max_blocks < 1 ||
      x_dtype < 0 || x_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(K, D);
  const long long tile = 32LL * l.warps;               // rows a block round
  long long rows = (R + max_blocks - 1) / max_blocks;
  rows = (rows + tile - 1) / tile * tile;
  const long long n_blocks = (R + rows - 1) / rows;   // <= max_blocks
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  float* pf = static_cast<float*>(part);
  int* ai = static_cast<int*>(assign);
  auto launch = x_dtype == 0   ? launch_partials<float>
                : x_dtype == 1 ? launch_partials<int16_t>
                               : launch_partials<int8_t>;
  const cudaError_t err = launch(grid, l, s, x, sxl, sxr, cf, scl, wf, swl,
                                 swr, sf, R, D, K, rows, pf, ai, sal);
  if (err != cudaSuccess) return static_cast<int>(err);
  km_reduce<<<L, kThreads, 0, s>>>(pf, static_cast<int>(n_blocks), D, K,
                                   static_cast<float*>(sums),
                                   static_cast<float*>(counts),
                                   static_cast<float*>(sse));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmeans_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
