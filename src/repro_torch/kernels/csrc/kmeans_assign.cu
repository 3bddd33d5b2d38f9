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
// The centroids (K x D float32) and |c|^2 live in shared memory.
//
// Exact assignments: x.c and |c|^2 are summed over j = 0..D-1 in order
// with __fmul_rn/__fadd_rn, so nvcc cannot contract them into FMAs, and
// d = |c|^2 - 2 x.c with __fsub_rn; the plain version
// (repro_torch.kernels.ref.kmeans_assign_ref) does the same elementwise in
// the same order, so assignments and counts are bit-equal to it.
//
// Deterministic sums, no float atomics: a block stages a tile of 256 rows
// (dequantized x, assignment, weight, sse term) in shared memory; then the
// thread that owns cell (k, j) of the statistics sums the tile's rows (four
// interleaved running sums, combined in a fixed order) and adds that tile
// sum to its cell.  Each block writes its
// partial statistics, and a second kernel adds the blocks' partials of
// each lane in block order.  So two launches on the same input give the
// same bits, and the three levels bound a cell's rounding by about (rows
// per tile + tiles per block + blocks) ulps of its mass, ~90 at the
// path's shapes, where one running sum over a block's ~13,000 rows would
// allow thousands (and int8 rows, which repeat values, drift that way).
//
// What bounds it on the H100: bytes in principle (each row is read once:
// 32 B at int16 x D=16, against 2*K*D = 256 flops), but this simple form
// is bound by instruction issue: a row's distances read the centroids
// from shared memory (rows of D <= 32 stay in registers), and a tile's
// statistics are summed by K*(D+1)+1 threads over all 256 rows each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // rows per tile: one row per thread

// float32 words of dynamic shared memory the partials kernel needs
// (kernels/kmeans_assign.py::smem_bytes mirrors it)
inline long long smem_words(int K, int D) {
  const int stride = D | 1;           // odd: conflict-free row reads
  const int cells = K * (D + 1) + 1;
  return static_cast<long long>(K) * D + K + D +
         static_cast<long long>(kThreads) * stride + 3LL * kThreads + cells;
}

// Nearest centroid of one dequantized row: x.c summed over j in order;
// kMaxD > 0 keeps the row in registers (D <= kMaxD), 0 reads it from
// shared memory.  Both give the same bits.
template <int kMaxD>
__device__ __forceinline__ int nearest(const float* xv, const float* xrow,
                                       const float* cs, const float* c2,
                                       int D, int K, float* best_out) {
  float best = 0.0f;
  int arg = 0;
  for (int k = 0; k < K; ++k) {
    const float* ck = cs + k * D;
    float dot = 0.0f;
    if (kMaxD > 0) {
#pragma unroll
      for (int j = 0; j < (kMaxD > 0 ? kMaxD : 1); ++j)
        if (j < D) dot = __fadd_rn(dot, __fmul_rn(xv[j], ck[j]));
    } else {
      for (int j = 0; j < D; ++j)
        dot = __fadd_rn(dot, __fmul_rn(xrow[j], ck[j]));
    }
    const float d = __fsub_rn(c2[k], __fmul_rn(2.0f, dot));
    if (k == 0 || d < best) {
      best = d;
      arg = k;
    }
  }
  *best_out = best;
  return arg;
}

// One cell's sum over a tile's n rows: kKind 0 = sums[k][j] (w x_j of
// the rows assigned to k), 1 = counts[k] (w), 2 = the sse terms.  Four
// running sums over rows t = u mod 4, combined in a fixed order: the
// additions overlap instead of waiting on one chain.
template <int kKind>
__device__ __forceinline__ float tile_sum(const int* as, const float* ws,
                                          const float* xs, const float* es,
                                          int stride, int k, int j, int n) {
  auto term = [&](int t) -> float {
    if (kKind == 2) return es[t];
    if (as[t] != k) return 0.0f;
    return kKind == 0 ? __fmul_rn(ws[t], xs[t * stride + j]) : ws[t];
  };
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int t = 0;
  for (; t + 4 <= n; t += 4) {
    s0 = __fadd_rn(s0, term(t));
    s1 = __fadd_rn(s1, term(t + 1));
    s2 = __fadd_rn(s2, term(t + 2));
    s3 = __fadd_rn(s3, term(t + 3));
  }
  for (; t < n; ++t) s0 = __fadd_rn(s0, term(t));
  return __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
}

template <typename T, bool kScaled, int kMaxD>
__global__ void __launch_bounds__(kThreads)
km_partials(const T* __restrict__ x, long long sxl, long long sxr,
            const float* __restrict__ c, long long scl,
            const float* __restrict__ w, long long swl, long long swr,
            const float* __restrict__ scale, long long R, int D, int K,
            long long rows_per_block, float* __restrict__ part,
            int* __restrict__ assign, long long sal) {
  extern __shared__ float sm[];
  const int stride = D | 1;
  const int cells = K * (D + 1) + 1;
  float* cs = sm;                                   // K*D centroids
  float* c2 = cs + K * D;                           // K   |c|^2
  float* sc = c2 + K;                               // D   scales
  float* xs = sc + D;                               // kThreads*stride rows
  float* ws = xs + kThreads * stride;               // kThreads weights
  float* es = ws + kThreads;                        // kThreads sse terms
  int* as = reinterpret_cast<int*>(es + kThreads);  // kThreads assignments
  float* acc = reinterpret_cast<float*>(as + kThreads);  // cells

  const int tid = threadIdx.x;
  const long long lane = blockIdx.y;
  const float* cl = c + lane * scl;
  for (int i = tid; i < K * D; i += kThreads) cs[i] = cl[i];
  if (kScaled)
    for (int i = tid; i < D; i += kThreads) sc[i] = scale[i];
  for (int i = tid; i < cells; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < D; ++j)
      s = __fadd_rn(s, __fmul_rn(cs[k * D + j], cs[k * D + j]));
    c2[k] = s;
  }
  __syncthreads();

  const T* xl = x + lane * sxl;
  const float* wl = w + lane * swl;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long row_end =
      row0 + rows_per_block < R ? row0 + rows_per_block : R;
  for (long long base = row0; base < row_end; base += kThreads) {
    const int n_here = static_cast<int>(
        row_end - base < kThreads ? row_end - base : kThreads);
    if (tid < n_here) {
      const long long r = base + tid;
      const T* xr = xl + r * sxr;
      float* xrow = xs + tid * stride;
      float xv[kMaxD > 0 ? kMaxD : 1];
      float x2 = 0.0f;
      if (kMaxD > 0) {
#pragma unroll
        for (int j = 0; j < (kMaxD > 0 ? kMaxD : 1); ++j) {
          if (j < D) {
            float v = static_cast<float>(xr[j]);
            if (kScaled) v = __fmul_rn(v, sc[j]);
            xv[j] = v;
            xrow[j] = v;
            x2 = __fadd_rn(x2, __fmul_rn(v, v));
          }
        }
      } else {
        for (int j = 0; j < D; ++j) {
          float v = static_cast<float>(xr[j]);
          if (kScaled) v = __fmul_rn(v, sc[j]);
          xrow[j] = v;
          x2 = __fadd_rn(x2, __fmul_rn(v, v));
        }
      }
      float best;
      const int arg = nearest<kMaxD>(xv, xrow, cs, c2, D, K, &best);
      const float wv = wl[r * swr];
      ws[tid] = wv;
      as[tid] = arg;
      es[tid] = __fmul_rn(__fadd_rn(best, x2), wv);
      if (assign != nullptr) assign[lane * sal + r] = arg;
    }
    __syncthreads();
    // cell < K*D: sums[k][j]; then K counts; then the sse.  The tile is
    // summed on its own and then added to the block's sum, so a cell's
    // rounding grows with rows/tile + tiles/block, not with its rows.
    for (int cell = tid; cell < cells; cell += kThreads) {
      float s;
      if (cell < K * D)
        s = tile_sum<0>(as, ws, xs, es, stride, cell / D, cell % D, n_here);
      else if (cell < K * D + K)
        s = tile_sum<1>(as, ws, xs, es, stride, cell - K * D, 0, n_here);
      else
        s = tile_sum<2>(as, ws, xs, es, stride, 0, 0, n_here);
      acc[cell] = __fadd_rn(acc[cell], s);
    }
    __syncthreads();
  }
  float* out = part + (lane * gridDim.x + blockIdx.x) * cells;
  for (int i = tid; i < cells; i += kThreads) out[i] = acc[i];
}

// One block per lane: add the lane's block partials in block order.
__global__ void __launch_bounds__(kThreads)
km_reduce(const float* __restrict__ part, int n_blocks, int D, int K,
          float* __restrict__ sums, float* __restrict__ counts,
          float* __restrict__ sse) {
  const int cells = K * (D + 1) + 1;
  const long long lane = blockIdx.x;
  const float* p = part + lane * n_blocks * cells;
  for (int cell = threadIdx.x; cell < cells; cell += kThreads) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s = __fadd_rn(s, p[b * cells + cell]);
    if (cell < K * D)
      sums[lane * K * D + cell] = s;
    else if (cell < K * D + K)
      counts[lane * K + cell - K * D] = s;
    else
      sse[lane] = s;
  }
}

template <typename T, bool kScaled, int kMaxD>
cudaError_t launch_at(dim3 grid, size_t smem, cudaStream_t stream,
                            const void* x, long long sxl, long long sxr,
                            const float* c, long long scl, const float* w,
                            long long swl, long long swr, const float* scale,
                            long long R, int D, int K, long long rows,
                            float* part, int* assign, long long sal) {
  auto kernel = km_partials<T, kScaled, kMaxD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sxl, sxr, c, scl, w, swl, swr, scale, R, D,
      K, rows, part, assign, sal);
  return cudaGetLastError();
}

// D <= 16 and D <= 32 keep each row in registers; wider rows stay in
// shared memory.
template <typename T, bool kScaled>
cudaError_t launch_partials(dim3 grid, size_t smem, cudaStream_t stream,
                            const void* x, long long sxl, long long sxr,
                            const float* c, long long scl, const float* w,
                            long long swl, long long swr, const float* scale,
                            long long R, int D, int K, long long rows,
                            float* part, int* assign, long long sal) {
  auto at = D <= 16   ? launch_at<T, kScaled, 16>
            : D <= 32 ? launch_at<T, kScaled, 32>
                      : launch_at<T, kScaled, 0>;
  return at(grid, smem, stream, x, sxl, sxr, c, scl, w, swl, swr, scale, R,
            D, K, rows, part, assign, sal);
}

}  // namespace

// x: (L, R, D) with unit stride along D; x_dtype 0 float32, 1 int16,
// 2 int8.  c: (K, D) contiguous per lane, lane stride scl (0 = shared).
// w: (L, R) float32.  scale: (D,) float32 or null (no dequantization).
// part: scratch of L * max_blocks * (K*(D+1)+1) float32.  Outputs sums
// (L, K, D), counts (L, K), sse (L,), contiguous; assign (L, R) int32 with
// lane stride sal, or null.  Returns cudaGetLastError() after the launches.
extern "C" int kmeans_assign_launch(
    const void* x, int x_dtype, long long sxl, long long sxr, const void* c,
    long long scl, const void* w, long long swl, long long swr,
    const void* scale, int L, long long R, int D, int K, int max_blocks,
    void* part, void* sums, void* counts, void* sse, void* assign,
    long long sal, void* stream) {
  if (L < 1 || L > 65535 || R < 1 || D < 1 || K < 1 || max_blocks < 1 ||
      x_dtype < 0 || x_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  long long rows = (R + max_blocks - 1) / max_blocks;
  rows = (rows + kThreads - 1) / kThreads * kThreads;
  const long long n_blocks = (R + rows - 1) / rows;   // <= max_blocks
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(L));
  const size_t smem = static_cast<size_t>(smem_words(K, D)) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  float* pf = static_cast<float*>(part);
  int* ai = static_cast<int*>(assign);
  cudaError_t err;
  if (x_dtype == 0)
    err = sf ? launch_partials<float, true>(grid, smem, s, x, sxl, sxr, cf,
                                            scl, wf, swl, swr, sf, R, D, K,
                                            rows, pf, ai, sal)
             : launch_partials<float, false>(grid, smem, s, x, sxl, sxr, cf,
                                             scl, wf, swl, swr, sf, R, D, K,
                                             rows, pf, ai, sal);
  else if (x_dtype == 1)
    err = sf ? launch_partials<int16_t, true>(grid, smem, s, x, sxl, sxr, cf,
                                              scl, wf, swl, swr, sf, R, D, K,
                                              rows, pf, ai, sal)
             : launch_partials<int16_t, false>(grid, smem, s, x, sxl, sxr,
                                               cf, scl, wf, swl, swr, sf, R,
                                               D, K, rows, pf, ai, sal);
  else
    err = sf ? launch_partials<int8_t, true>(grid, smem, s, x, sxl, sxr, cf,
                                             scl, wf, swl, swr, sf, R, D, K,
                                             rows, pf, ai, sal)
             : launch_partials<int8_t, false>(grid, smem, s, x, sxl, sxr, cf,
                                              scl, wf, swl, swr, sf, R, D, K,
                                              rows, pf, ai, sal);
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
