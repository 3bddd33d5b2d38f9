// fxp_matmul: lane-batched integer product with int32 accumulation over
// K-chunks, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fxp_matmul.py::fxp_matmul
// (_fxp_kernel, a tiled MXU s8 matmul with K as the sequential grid axis),
// as repro/kernels/dispatch.py::hybrid_matmul drives it: every K-chunk of
// `kc` columns gets its own int32 partial, which the wrapper converts to
// float32 and sums in chunk order, so the float result equals the JAX
// package's bit for bit.
//
//   C[l, c, m, n] = sum_{k in chunk c} limb(A[l, m, k]) * B[l, k, n]
//
// A is the resident dataset: int8 (used as it is), or int16 read as its
// high limb (x >> 8, signed) or low limb (x & 0xFF, unsigned).  The limb is
// taken in registers, so no int16 or limb copy of the dataset is ever made.
// B holds the int16-typed limbs of the weight or residual (values in
// [-128, 255]); all of B's limbs ride as its N columns, so one launch reads
// A once for every limb of B.  A and B are addressed by strides: the
// gradient's X^T is the (L, d, R) transposed view of the (L, R, d)
// resident tensor, and a B shared by every lane has lane stride 0.
//
// What bounds it on the H100: bytes.  On the training path N = 2 and each
// byte of A meets two multiply-adds, far below the card's int8 rate, so the
// time is the one pass over A (1 GiB at 256 lanes x 65,536 rows x 64
// features).  The design keeps that pass coalesced and wide for both
// layouts the path gives it, with one 16-byte load (16 int8 or 8 int16
// elements) per thread:
//   * rows (A contiguous along k, the forward X.w): G threads share a row,
//     each holding one 16-byte piece of it; a thread's k's are the same in
//     every row, so its B values stay in registers for the whole block, and
//     the G threads reduce with warp shuffles;
//   * cols (A contiguous along m, the gradient X^T.r): a thread takes 16
//     consecutive m of one k row, neighbouring threads the next 16 m or the
//     next row, each thread walks k with a stride of its block's k-groups,
//     and the block reduces its k-groups through padded shared memory.
// Layouts the vector kernels cannot take (unaligned, ragged K or M, N > 4,
// other strides) go to scalar kernels with the same mappings and one
// element per thread.  cp.async/TMA staging is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8;

// LIMB 0: the int8 value; 1: high limb of an int16; 2: its low limb.
template <typename TA, int LIMB>
__device__ __forceinline__ int load_limb(const TA* p) {
  const int v = static_cast<int>(__ldg(p));
  if (LIMB == 1) return v >> 8;
  if (LIMB == 2) return v & 0xFF;
  return v;
}

template <typename TA, int LIMB>
__global__ void __launch_bounds__(kThreads)
fxp_rows_kernel(const TA* __restrict__ A, const int16_t* __restrict__ B,
                int32_t* __restrict__ C, int M, int K, int N, int kc,
                int n_chunks, int64_t sAl, int64_t sAm, int64_t sAk,
                int64_t sBl, int64_t sBk, int64_t sBn, int G,
                int rows_per_block) {
  const int l = blockIdx.z;
  const int c = blockIdx.y;
  const int k0 = c * kc;
  const int k1 = min(k0 + kc, K);
  const int sub = threadIdx.x % G;       // lane within the row group
  const int grp = threadIdx.x / G;       // row group within the block
  const int groups = kThreads / G;
  const TA* Al = A + l * sAl;
  const int16_t* Bl = B + l * sBl;
  int32_t* Cl = C + (static_cast<int64_t>(l) * n_chunks + c) *
                        static_cast<int64_t>(M) * N;
  const int m_begin = blockIdx.x * rows_per_block;
  const int m_end = min(M, m_begin + rows_per_block);

  // The loop bounds are the same for every thread of the block, so every
  // lane of a warp reaches the shuffles below.
  for (int m0 = m_begin; m0 < m_end; m0 += groups) {
    const int m = m0 + grp;
    int acc[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) acc[n] = 0;
    if (m < m_end) {
      const TA* pa = Al + m * sAm + (k0 + sub) * sAk;
      const int16_t* pb = Bl + (k0 + sub) * sBk;
      const int64_t step_a = G * sAk;
      const int64_t step_b = G * sBk;
#pragma unroll 4
      for (int k = k0 + sub; k < k1; k += G, pa += step_a, pb += step_b) {
        const int a = load_limb<TA, LIMB>(pa);
#pragma unroll
        for (int n = 0; n < kMaxN; ++n)
          if (n < N) acc[n] += a * static_cast<int>(__ldg(pb + n * sBn));
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n < N) {
        for (int off = G / 2; off > 0; off >>= 1)
          acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
      }
    }
    if (m < m_end && sub == 0) {
      for (int n = 0; n < N; ++n) Cl[static_cast<int64_t>(m) * N + n] = acc[n];
    }
  }
}

template <typename TA, int LIMB>
__global__ void __launch_bounds__(kThreads)
fxp_cols_kernel(const TA* __restrict__ A, const int16_t* __restrict__ B,
                int32_t* __restrict__ C, int M, int K, int N, int kc,
                int n_chunks, int64_t sAl, int64_t sAm, int64_t sAk,
                int64_t sBl, int64_t sBk, int64_t sBn, int TM) {
  __shared__ int red[kMaxN * kThreads];
  const int l = blockIdx.z;
  const int c = blockIdx.y;
  const int k0 = c * kc;
  const int k1 = min(k0 + kc, K);
  const int mi = threadIdx.x % TM;
  const int kg = threadIdx.x / TM;
  const int G = kThreads / TM;           // k-groups in the block
  const int m = blockIdx.x * TM + mi;
  const TA* Al = A + l * sAl;
  const int16_t* Bl = B + l * sBl;
  int32_t* Cl = C + (static_cast<int64_t>(l) * n_chunks + c) *
                        static_cast<int64_t>(M) * N;

  int acc[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) acc[n] = 0;
  if (m < M) {
    const TA* pa = Al + m * sAm + (k0 + kg) * sAk;
    const int16_t* pb = Bl + (k0 + kg) * sBk;
    const int64_t step_a = G * sAk;
    const int64_t step_b = G * sBk;
#pragma unroll 4
    for (int k = k0 + kg; k < k1; k += G, pa += step_a, pb += step_b) {
      const int a = load_limb<TA, LIMB>(pa);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        if (n < N) acc[n] += a * static_cast<int>(__ldg(pb + n * sBn));
    }
  }
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) red[n * kThreads + threadIdx.x] = acc[n];
  __syncthreads();
  if (kg == 0 && m < M) {
    for (int n = 0; n < N; ++n) {
      int s = 0;
      for (int g = 0; g < G; ++g) s += red[n * kThreads + g * TM + mi];
      Cl[static_cast<int64_t>(m) * N + n] = s;
    }
  }
}

// The VEC elements of one 16-byte load, as limbs.
template <typename TA, int LIMB, int VEC>
__device__ __forceinline__ void unpack(const int4 v, int (&out)[VEC]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    int x;
    if (sizeof(TA) == 1)
      x = static_cast<int8_t>(w[e >> 2] >> ((e & 3) * 8));
    else
      x = static_cast<int16_t>(w[e >> 1] >> ((e & 1) * 16));
    out[e] = LIMB == 1 ? (x >> 8) : (LIMB == 2 ? (x & 0xFF) : x);
  }
}

// rows, vectorised: A[m, k] contiguous along k; the chunk is at most G
// vectors wide, so each thread owns one vector of every row.
template <typename TA, int LIMB, int N>
__global__ void __launch_bounds__(kThreads)
fxp_rows_vec_kernel(const TA* __restrict__ A, const int16_t* __restrict__ B,
                    int32_t* __restrict__ C, int M, int K, int kc,
                    int n_chunks, int64_t sAl, int64_t sAm, int64_t sBl,
                    int64_t sBk, int64_t sBn, int G, int rows_per_block) {
  constexpr int VEC = 16 / sizeof(TA);
  const int l = blockIdx.z;
  const int c = blockIdx.y;
  const int k1 = min(c * kc + kc, K);
  const int sub = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int groups = kThreads / G;
  const int k = c * kc + sub * VEC;      // this thread's first k
  const bool has_k = k < k1;             // K % VEC == 0: whole vectors only
  const TA* Al = A + l * sAl + k;
  const int16_t* Bl = B + l * sBl;
  int32_t* Cl = C + (static_cast<int64_t>(l) * n_chunks + c) *
                        static_cast<int64_t>(M) * N;
  int bv[VEC][N];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
#pragma unroll
    for (int n = 0; n < N; ++n)
      bv[e][n] = has_k ? static_cast<int>(__ldg(Bl + (k + e) * sBk + n * sBn))
                       : 0;
  const int m_begin = blockIdx.x * rows_per_block;
  const int m_end = min(M, m_begin + rows_per_block);
#pragma unroll 4
  for (int m0 = m_begin; m0 < m_end; m0 += groups) {
    const int m = m0 + grp;
    int acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0;
    if (m < m_end && has_k) {
      int a[VEC];
      unpack<TA, LIMB, VEC>(__ldg(reinterpret_cast<const int4*>(Al + m * sAm)),
                            a);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[n] += a[e] * bv[e][n];
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
      for (int off = G / 2; off > 0; off >>= 1)
        acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
    if (m < m_end && sub == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) Cl[static_cast<int64_t>(m) * N + n] = acc[n];
    }
  }
}

// cols, vectorised: A[m, k] contiguous along m; a thread takes VEC
// consecutive m, TV threads cover the block's TV*VEC m of one k row.
template <typename TA, int LIMB, int N>
__global__ void __launch_bounds__(kThreads)
fxp_cols_vec_kernel(const TA* __restrict__ A, const int16_t* __restrict__ B,
                    int32_t* __restrict__ C, int M, int K, int kc,
                    int n_chunks, int64_t sAl, int64_t sAk, int64_t sBl,
                    int64_t sBk, int64_t sBn, int TV) {
  constexpr int VEC = 16 / sizeof(TA);
  constexpr int kPad = kThreads + 1;     // staggers the banks of the reads
  __shared__ int red[VEC * kPad];
  const int l = blockIdx.z;
  const int c = blockIdx.y;
  const int k0 = c * kc;
  const int k1 = min(k0 + kc, K);
  const int tv = threadIdx.x % TV;
  const int kg = threadIdx.x / TV;
  const int G = kThreads / TV;           // k-groups in the block
  const int m = (blockIdx.x * TV + tv) * VEC;
  const TA* Al = A + l * sAl;
  const int16_t* Bl = B + l * sBl;
  int32_t* Cl = C + (static_cast<int64_t>(l) * n_chunks + c) *
                        static_cast<int64_t>(M) * N;

  int acc[VEC][N];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[e][n] = 0;
  if (m < M) {                           // M % VEC == 0: whole vectors only
    const TA* pa = Al + m + (k0 + kg) * sAk;
    const int16_t* pb = Bl + (k0 + kg) * sBk;
    const int64_t step_a = G * sAk;
    const int64_t step_b = G * sBk;
#pragma unroll 2
    for (int k = k0 + kg; k < k1; k += G, pa += step_a, pb += step_b) {
      int a[VEC];
      unpack<TA, LIMB, VEC>(__ldg(reinterpret_cast<const int4*>(pa)), a);
      int b[N];
#pragma unroll
      for (int n = 0; n < N; ++n) b[n] = static_cast<int>(__ldg(pb + n * sBn));
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[e][n] += a[e] * b[n];
    }
  }
  // thread t < TV*VEC sums output m = block's first m + t over the k-groups
  const int om = blockIdx.x * TV * VEC + threadIdx.x;
  const int otv = threadIdx.x / VEC;
  const int oe = threadIdx.x % VEC;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[e * kPad + threadIdx.x] = acc[e][n];
    __syncthreads();
    if (threadIdx.x < TV * VEC && om < M) {
      int s = 0;
      for (int g = 0; g < G; ++g) s += red[oe * kPad + g * TV + otv];
      Cl[static_cast<int64_t>(om) * N + n] = s;
    }
    __syncthreads();
  }
}

int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The vector kernels for N in [1, 4]; returns false when they cannot take
// this layout.
template <typename TA, int LIMB, int N>
bool launch_vec(const void* A, const void* B, void* C, int L, int M, int K,
                int kc, int64_t sAl, int64_t sAm, int64_t sAk, int64_t sBl,
                int64_t sBk, int64_t sBn, int cols, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TA);
  constexpr int64_t esz = sizeof(TA);
  const int n_chunks = (K + kc - 1) / kc;
  if (reinterpret_cast<uintptr_t>(A) % 16 != 0 || (sAl * esz) % 16 != 0)
    return false;
  const TA* a = static_cast<const TA*>(A);
  const int16_t* b = static_cast<const int16_t*>(B);
  int32_t* out = static_cast<int32_t*>(C);
  if (!cols && sAk == 1 && (sAm * esz) % 16 == 0 && kc % VEC == 0 &&
      K % VEC == 0 && kc <= 32 * VEC) {
    const int G = pow2_ceil(kc / VEC);
    const int rows_per_block = (kThreads / G) * 8;
    dim3 grid((M + rows_per_block - 1) / rows_per_block, n_chunks, L);
    fxp_rows_vec_kernel<TA, LIMB, N><<<grid, kThreads, 0, stream>>>(
        a, b, out, M, K, kc, n_chunks, sAl, sAm, sBl, sBk, sBn, G,
        rows_per_block);
    return true;
  }
  if (cols && sAm == 1 && (sAk * esz) % 16 == 0 && M % VEC == 0) {
    const int TV = min(kThreads / VEC, pow2_ceil(M / VEC));
    dim3 grid((M + TV * VEC - 1) / (TV * VEC), n_chunks, L);
    fxp_cols_vec_kernel<TA, LIMB, N><<<grid, kThreads, 0, stream>>>(
        a, b, out, M, K, kc, n_chunks, sAl, sAk, sBl, sBk, sBn, TV);
    return true;
  }
  return false;
}

template <typename TA, int LIMB>
void launch(const void* A, const void* B, void* C, int L, int M, int K,
            int N, int kc, int64_t sAl, int64_t sAm, int64_t sAk,
            int64_t sBl, int64_t sBk, int64_t sBn, int cols, int param,
            cudaStream_t stream) {
  bool done = false;
  switch (N) {
    case 1: done = launch_vec<TA, LIMB, 1>(A, B, C, L, M, K, kc, sAl, sAm,
                                           sAk, sBl, sBk, sBn, cols, stream);
            break;
    case 2: done = launch_vec<TA, LIMB, 2>(A, B, C, L, M, K, kc, sAl, sAm,
                                           sAk, sBl, sBk, sBn, cols, stream);
            break;
    case 3: done = launch_vec<TA, LIMB, 3>(A, B, C, L, M, K, kc, sAl, sAm,
                                           sAk, sBl, sBk, sBn, cols, stream);
            break;
    case 4: done = launch_vec<TA, LIMB, 4>(A, B, C, L, M, K, kc, sAl, sAm,
                                           sAk, sBl, sBk, sBn, cols, stream);
            break;
    default: break;
  }
  if (done) return;
  const int n_chunks = (K + kc - 1) / kc;
  const TA* a = static_cast<const TA*>(A);
  const int16_t* b = static_cast<const int16_t*>(B);
  int32_t* out = static_cast<int32_t*>(C);
  if (cols) {
    const int TM = param;  // m per block: a power of two in [1, 256]
    dim3 grid((M + TM - 1) / TM, n_chunks, L);
    fxp_cols_kernel<TA, LIMB><<<grid, kThreads, 0, stream>>>(
        a, b, out, M, K, N, kc, n_chunks, sAl, sAm, sAk, sBl, sBk, sBn, TM);
  } else {
    const int G = param;   // lanes per row: a power of two in [1, 32]
    const int rows_per_block = (kThreads / G) * 8;
    dim3 grid((M + rows_per_block - 1) / rows_per_block, n_chunks, L);
    fxp_rows_kernel<TA, LIMB><<<grid, kThreads, 0, stream>>>(
        a, b, out, M, K, N, kc, n_chunks, sAl, sAm, sAk, sBl, sBk, sBn, G,
        rows_per_block);
  }
}

}  // namespace

// a_kind: 0 = int8 A, 1 = high limb of int16 A, 2 = low limb of int16 A.
// cols: 1 for the column mapping (param = TM), 0 for rows (param = G).
// Strides are in elements.  Returns cudaGetLastError() after the launch.
extern "C" int fxp_matmul_launch(const void* A, int a_kind, const void* B,
                                 void* C, int L, int M, int K, int N, int kc,
                                 long long sAl, long long sAm, long long sAk,
                                 long long sBl, long long sBk, long long sBn,
                                 int cols, int param, void* stream) {
  if (N < 1 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_kind) {
    case 0:
      launch<int8_t, 0>(A, B, C, L, M, K, N, kc, sAl, sAm, sAk, sBl, sBk,
                        sBn, cols, param, s);
      break;
    case 1:
      launch<int16_t, 1>(A, B, C, L, M, K, N, kc, sAl, sAm, sAk, sBl, sBk,
                         sBn, cols, param, s);
      break;
    case 2:
      launch<int16_t, 2>(A, B, C, L, M, K, N, kc, sAl, sAm, sAk, sBl, sBk,
                         sBn, cols, param, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fxp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
