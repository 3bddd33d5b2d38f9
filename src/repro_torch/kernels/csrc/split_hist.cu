// split_hist: one decision-tree level's weighted split histogram for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/split_hist.py::split_hist
// (_hist_kernel), which turns the DPU's scalar scatter into a one-hot
// matmul: a (rows, F, nodes*bins*classes) one-hot contracted on the MXU
// and accumulated in VMEM across a sequential grid.  A GPU scatters into
// shared memory directly, so this kernel keeps a histogram tile in shared
// memory and adds each (row, feature) element to it with atomicAdd:
//
//   H[lane, node[r], f, xbin[r, f], y[r]] += w[r]    for every row r, f
//
// Rows whose node, bin or class lies outside [0, n) add nothing (the
// kernel never writes outside its output), nor do rows of weight 0.
//
// Tiling: the full tree's last pass holds 64 nodes x 16 features x 32
// bins x 4 classes = 512 KiB per lane, more than an SM's shared memory, so
// the features are cut into tiles (one feature is 32 KiB at 64 nodes) and
// a lane's rows into chunks.  Block (tile, chunk, lane) zeroes its
// shared histogram, adds its chunk's rows (one row per thread, its node,
// class and weight read once for all the tile's features), then adds its
// non-zero cells into the zeroed global output.  The feature tile is the
// fastest grid dimension, so the blocks that read one chunk's rows run
// together and share them in L2.
//
// Exactness: the weights are the 0/1 row mask and a lane holds at most
// 2^24 rows (the wrapper checks), so every partial is an integer-valued
// float below 2^24 and every addition is exact: the result is bit-equal
// to the plain version and the same on every launch, whatever the order
// of the atomics.
//
// What bounds it on the H100: bytes in principle (76 B a row at F=16
// int32 bins, one add per element).  This simple form stays well above
// that bound and is slowest where a block holds one feature (64 nodes):
// then each of a row's 16 blocks reads its 4 B at a 64 B stride.  Depth 0,
// where every row falls in node 0 and a feature's increments share
// bins*classes = 128 counters, is not the slow pass (see PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename B>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ node, long long snl, long long snr,
            const B* __restrict__ xbin, long long sxl, long long sxr,
            const int* __restrict__ y, long long syl, long long syr,
            const float* __restrict__ w, long long swl, long long swr,
            int R, int F, int n_nodes, int n_bins, int n_classes, int ft,
            int rows_per_block, float* __restrict__ H) {
  extern __shared__ float hs[];
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * ft;
  const int nf = F - f0 < ft ? F - f0 : ft;
  const int cells = n_nodes * nf * n_bins * n_classes;
  for (int i = tid; i < cells; i += kThreads) hs[i] = 0.0f;
  __syncthreads();

  const long long lane = blockIdx.z;
  const int row0 = blockIdx.y * rows_per_block;
  const int row_end = R - row0 < rows_per_block ? R : row0 + rows_per_block;
  const int* nl = node + lane * snl;
  const B* xl = xbin + lane * sxl + f0;
  const int* yl = y + lane * syl;
  const float* wl = w + lane * swl;
  // one row per thread: its node, class and weight are read once, then
  // each of the tile's features adds to its own histogram
  const int fstride = n_bins * n_classes;
  for (int r = row0 + tid; r < row_end; r += kThreads) {
    const long long rr = r;
    const float wv = wl[rr * swr];
    if (wv == 0.0f) continue;
    const int nd = nl[rr * snr];
    const int yc = yl[rr * syr];
    if (nd < 0 || nd >= n_nodes || yc < 0 || yc >= n_classes) continue;
    float* h = hs + nd * nf * fstride + yc;
    const B* xr = xl + rr * sxr;
    for (int fi = 0; fi < nf; ++fi) {
      const int b = static_cast<int>(xr[fi]);
      if (b >= 0 && b < n_bins)
        atomicAdd(&h[fi * fstride + b * n_classes], wv);
    }
  }
  __syncthreads();

  // H is (L, n_nodes, F, n_bins, n_classes)
  const int bc = n_bins * n_classes;
  for (int i = tid; i < cells; i += kThreads) {
    const float v = hs[i];
    if (v == 0.0f) continue;
    const int nd = i / (nf * bc);
    const int rest = i - nd * nf * bc;
    const int fi = rest / bc;
    const long long at = ((lane * n_nodes + nd) * F + f0 + fi) * bc +
                         (rest - fi * bc);
    atomicAdd(&H[at], v);
  }
}

template <typename B>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const int* node, long long snl, long long snr,
                   const void* xbin, long long sxl, long long sxr,
                   const int* y, long long syl, long long syr, const float* w,
                   long long swl, long long swr, int R, int F, int n_nodes,
                   int n_bins, int n_classes, int ft, int rows, float* H) {
  auto kernel = hist_kernel<B>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      node, snl, snr, static_cast<const B*>(xbin), sxl, sxr, y, syl, syr, w,
      swl, swr, R, F, n_nodes, n_bins, n_classes, ft, rows, H);
  return cudaGetLastError();
}

}  // namespace

// node, y: (L, R) int32; xbin: (L, R, F) with unit stride along F,
// xbin_dtype 0 int32, 1 int16, 2 uint8; w: (L, R) float32; each with its
// lane and row strides.  H: (L, n_nodes, F, n_bins, n_classes) float32,
// contiguous and zeroed.  ft features per block, n_chunks row chunks per
// lane.  Returns cudaGetLastError() after the launch.
extern "C" int split_hist_launch(
    const void* node, long long snl, long long snr, const void* xbin,
    int xbin_dtype, long long sxl, long long sxr, const void* y,
    long long syl, long long syr, const void* w, long long swl,
    long long swr, int L, int R, int F, int n_nodes, int n_bins,
    int n_classes, int ft, int n_chunks, void* H, void* stream) {
  if (L < 1 || L > 65535 || R < 1 || F < 1 || n_nodes < 1 || n_bins < 1 ||
      n_classes < 1 || ft < 1 || n_chunks < 1 || n_chunks > 65535 ||
      xbin_dtype < 0 || xbin_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ft > F) ft = F;
  const int rows = (R + n_chunks - 1) / n_chunks;
  const int chunks = (R + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>((F + ft - 1) / ft),
                  static_cast<unsigned>(chunks), static_cast<unsigned>(L));
  const size_t smem = static_cast<size_t>(n_nodes) * ft * n_bins *
                      n_classes * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ni = static_cast<const int*>(node);
  const int* yi = static_cast<const int*>(y);
  const float* wf = static_cast<const float*>(w);
  float* h = static_cast<float*>(H);
  cudaError_t err;
  if (xbin_dtype == 0)
    err = launch<int32_t>(grid, smem, s, ni, snl, snr, xbin, sxl, sxr, yi,
                          syl, syr, wf, swl, swr, R, F, n_nodes, n_bins,
                          n_classes, ft, rows, h);
  else if (xbin_dtype == 1)
    err = launch<int16_t>(grid, smem, s, ni, snl, snr, xbin, sxl, sxr, yi,
                          syl, syr, wf, swl, swr, R, F, n_nodes, n_bins,
                          n_classes, ft, rows, h);
  else
    err = launch<uint8_t>(grid, smem, s, ni, snl, snr, xbin, sxl, sxr, yi,
                          syl, syr, wf, swl, swr, R, F, n_nodes, n_bins,
                          n_classes, ft, rows, h);
  return static_cast<int>(err);
}

extern "C" const char* split_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
