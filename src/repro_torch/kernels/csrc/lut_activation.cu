// lut_activation: nearest-entry lookup-table activation for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lut_activation.py::lut_activation
// (_lut_kernel), which evaluates the lookup as one_hot(idx) @ table on the
// MXU because a systolic array has no fast gather.  A GPU gathers from
// shared memory directly, so each block copies the table (1024 float32 =
// 4 KB on the sigmoid path) into shared memory once and every element is
// one shared-memory load.
//
//   idx = clip(rint((x - x_min) / step), 0, n - 1);  out = table[idx]
//
// The index equals repro.core.lut._index bit for bit: x_min and step are
// rounded from the host's doubles to float32 once, the subtract and the
// divide are IEEE float32 with round-to-nearest (__fsub_rn, __fdiv_rn: a
// true divide, never a reciprocal multiply), rintf rounds half to even like
// jnp.round, and the clamp comes before the conversion to int.  This file
// must not be built with --use_fast_math.
//
// What bounds it on the H100: bytes.  Each element reads 4 B and writes
// 4 B; the divide and the shared-memory load are far below the card's
// rates.  A grid-stride loop with neighbouring threads on neighbouring
// elements keeps both streams coalesced, and the grid is sized to a few
// blocks per SM so the table copy is paid a few thousand times, not once
// per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lut_kernel(const float* __restrict__ x, const float* __restrict__ table,
           float* __restrict__ out, int64_t n, int n_entries, float x_min,
           float step) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_entries; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const float hi = static_cast<float>(n_entries - 1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float pos = rintf(__fdiv_rn(__fsub_rn(x[i], x_min), step));
    pos = fminf(fmaxf(pos, 0.0f), hi);
    out[i] = tab[static_cast<int>(pos)];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.  `max_blocks` caps the grid
// (the wrapper passes a few blocks per SM).
extern "C" int lut_activation_launch(const void* x, const void* table,
                                     void* out, long long n, int n_entries,
                                     float x_min, float step, int max_blocks,
                                     void* stream) {
  if (n <= 0 || n_entries < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = static_cast<size_t>(n_entries) * sizeof(float);
  lut_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(table),
      static_cast<float*>(out), n, n_entries, x_min, step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lut_activation_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
