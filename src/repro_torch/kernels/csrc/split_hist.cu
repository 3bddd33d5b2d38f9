// split_hist: one decision-tree level's weighted split histogram for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/split_hist.py::split_hist
// (_hist_kernel), which turns the DPU's scalar scatter into a one-hot
// matmul: a (rows, F, nodes*bins*classes) one-hot contracted on the MXU
// and accumulated in VMEM across a sequential grid.  A GPU scatters into
// shared memory directly, so this kernel keeps a histogram tile in shared
// memory and adds each (row, feature) element to it with a shared atomic:
//
//   H[lane, node[r], f, xbin[r, f], y[r]] += w[r]    for every row r, f
//
// Rows whose node, bin or class lies outside [0, n) add nothing (the
// kernel never writes outside its output), nor do rows of weight 0.
//
// What bounds it on the H100: in principle bytes (the bins, node, y and w
// read once, H written once: 28 B a row at F = 16 uint8 bins, 76 B at
// int32).  Measured (PERF.md), the tree's uint8 rows are held to ~0.2 ms
// a pass by the shared atomics themselves: about 280 warp-wide atomics an
// SM a microsecond, whether their 32 lanes hit 32 banks or not, and
// whether rows come from HBM or L2.  Its design:
//
// * Whole-SM tiles.  Block (tile, chunk, lane) holds the histogram of a
//   tile of features for every node in up to 227 KB of shared memory, so
//   a lane's rows are read by as few blocks as the histogram allows: one
//   up to 16 nodes at the tree's F = 16, 32 bins, 4 classes, two at 32
//   nodes, three at 64.  The feature tile is the fastest grid dimension,
//   so the blocks that read one lane's rows run together and share them
//   in L2.  (A cluster of a lane's tiles that reads each row once and
//   adds into the other blocks' tiles through distributed shared memory
//   was 5-7x slower at 32 and 64 nodes: its remote atomics are slow.)
// * Rows read ahead of their adds, in one load where they fit it.  A
//   row's bins are one 16-byte load where its F bins fit 16 bytes and its
//   base and strides are 16-byte aligned (the tree's uint8 bins at F =
//   16); else one load an element.  Each thread loads its next two rows
//   before it adds the two it holds.
// * Integer counts.  With 0/1 weights (the row mask) each element adds 1
//   to a uint32 counter (a native shared atomic, ATOMS.POPC.INC, which
//   also merges a warp's adds to one address: depth 0, where a feature's
//   adds share 128 counters, runs as fast as 16 nodes); a float add to
//   shared memory is a compare-and-swap loop.  A block that meets any
//   other weight clears its tile and walks its rows again in float.
// * No global atomics in the flush.  Where one block owns a (lane,
//   feature tile) for all the lane's rows, it stores every cell of its
//   tile, zeros included, so H needs no zeroing.  Where the wrapper cuts
//   the rows into chunks to fill the card (few lanes), each block adds its
//   tile for each node into the zeroed H with one bulk reduce-add
//   (cp.reduce.async.bulk ... add.f32) plus at most six scalar atomics
//   at the run's unaligned ends.
// * Bank spread.  Stored cell by cell, the tile keeps the features
//   fastest with an odd stride between (node, bin, class) groups, so a
//   warp's flush reads hit 32 banks; the bulk layout is H's own order.
//
// Exactness: the weights are the 0/1 row mask and a lane holds at most
// 2^24 rows (the wrapper checks), so every count is an integer below 2^24,
// exact as a float32: the result is bit-equal to the plain version and
// the same on every launch, whatever the order of the atomics.  Other
// weights are added as float atomics, in an order that may change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;          // kernels.split_hist.THREADS
constexpr int kMaxSmemBytes = 232448;   // 227 KB a block (MAX_SMEM_BYTES)

// One level's inputs, output and the block's shared layout: cell (node,
// feature f of the tile starting at f0, bin, class) is word
// s0 + node * sN + (f - f0) * sF + (bin * classes + class) * sC.
struct Level {
  const int* node;
  long long snl, snr;
  const void* xbin;
  long long sxl, sxr;
  const int* y;
  long long syl, syr;
  const float* w;
  long long swl, swr;
  int R, F, nodes, bins, classes;
  int nf;      // features a tile (the last tile may hold fewer)
  int rows;    // rows a chunk
  int sN, sF, sC;
  int bulk;    // 1: add into a zeroed H (bulk layout); 0: store every cell
  float* H;    // (L, nodes, F, bins, classes) float32, contiguous
};

// Element e of a row held as one 16-byte vector.
template <typename B>
__device__ __forceinline__ int element(const uint4& q, int e) {
  constexpr int kPer = 4 / sizeof(B);            // elements a 32-bit word
  const int j = e / kPer;
  const unsigned word = j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  if constexpr (sizeof(B) == 1) {
    return static_cast<int>((word >> (8 * (e % 4))) & 0xffu);
  } else if constexpr (sizeof(B) == 2) {
    return static_cast<int>(static_cast<B>(word >> (16 * (e % 2))));
  } else {
    return static_cast<int>(word);
  }
}

template <bool kUnit>
__device__ __forceinline__ void add(unsigned* cell, float wv) {
  if constexpr (kUnit) {
    atomicAdd(cell, 1u);
  } else {
    atomicAdd(reinterpret_cast<float*>(cell), wv);
  }
}

// A row as a thread holds it between its loads and its adds: weight,
// node, class and, on the vector path (kVec), its bins as one 16-byte
// vector.
struct Row {
  float w;
  int nd, yc;
  uint4 v;
};

// One lane's inputs and the block's tile, as the walk reads them.
template <typename B>
struct Walk {
  const int* nl;
  const int* yl;
  const float* wl;
  const B* xl;
  long long snr, syr, swr, sxr;
  int row_end, nodes, classes, bins, f0, nf, base, sN, sF, sC, s_bin;
};

template <typename B, bool kVec>
__device__ __forceinline__ void fetch(Row& x, const Walk<B>& k, int r) {
  x.w = 0.0f;                      // a row past the end adds nothing
  x.nd = 0;
  x.yc = 0;
  if (r < k.row_end) {
    const long long rr = r;
    x.w = k.wl[rr * k.swr];
    x.nd = k.nl[rr * k.snr];
    x.yc = k.yl[rr * k.syr];
    if constexpr (kVec)
      x.v = __ldg(reinterpret_cast<const uint4*>(k.xl + rr * k.sxr));
  }
}

// Adds one held row to the tile; returns whether, with kUnit, its weight
// was neither 0 nor 1 (then it added nothing).
template <typename B, bool kVec, bool kUnit>
__device__ __forceinline__ bool put(const Row& x, const Walk<B>& k,
                                    unsigned* hs, int r) {
  if constexpr (kUnit) {
    if (x.w != 1.0f) return x.w != 0.0f;
  } else if (x.w == 0.0f) {
    return false;
  }
  if (static_cast<unsigned>(x.nd) >= static_cast<unsigned>(k.nodes) ||
      static_cast<unsigned>(x.yc) >= static_cast<unsigned>(k.classes))
    return false;
  const int h = k.base + x.nd * k.sN + x.yc * k.sC;
  if constexpr (kVec) {
#pragma unroll
    for (int e = 0; e < static_cast<int>(16 / sizeof(B)); ++e) {
      if (static_cast<unsigned>(e - k.f0) < static_cast<unsigned>(k.nf)) {
        const int b = element<B>(x.v, e);
        if (static_cast<unsigned>(b) < static_cast<unsigned>(k.bins))
          add<kUnit>(hs + (h + e * k.sF + b * k.s_bin), x.w);
      }
    }
  } else {
    const B* xr = k.xl + static_cast<long long>(r) * k.sxr;
#pragma unroll 4
    for (int f = k.f0; f < k.f0 + k.nf; ++f) {
      const int b = static_cast<int>(xr[f]);
      if (static_cast<unsigned>(b) < static_cast<unsigned>(k.bins))
        add<kUnit>(hs + (h + f * k.sF + b * k.s_bin), x.w);
    }
  }
  return false;
}

// Adds the block's rows into its tile, kU rows a thread a step, the next
// step's rows loaded before this step's adds (so a warp keeps its loads
// in flight while it adds).  kUnit: rows of weight 1 add 1 to an integer
// count, rows of weight 0 nothing; returns whether any row had another
// weight (then nothing of that row was added).
template <typename B, bool kVec, bool kUnit>
__device__ bool walk(const Level& a, unsigned* hs, long long lane, int f0,
                     int nf, int s0, int row0, int row_end) {
  constexpr int kU = 2;
  const Walk<B> k{a.node + lane * a.snl, a.y + lane * a.syl,
                  a.w + lane * a.swl,
                  static_cast<const B*>(a.xbin) + lane * a.sxl, a.snr, a.syr,
                  a.swr, a.sxr, row_end, a.nodes, a.classes, a.bins, f0, nf,
                  s0 - f0 * a.sF,  // feature f of the tile at + f * sF
                  a.sN, a.sF, a.sC, a.classes * a.sC};
  bool bad = false;
  Row cur[kU], nxt[kU];
  int r = row0 + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int u = 0; u < kU; ++u) fetch<B, kVec>(cur[u], k, r + u * kThreads);
  for (; r < row_end; r += kU * kThreads) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      fetch<B, kVec>(nxt[u], k, r + (kU + u) * kThreads);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      bad |= put<B, kVec, kUnit>(cur[u], k, hs, r + u * kThreads);
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
  return bad;
}

// Every cell of the tile stored into H, zeros included: warps take (node,
// feature) runs, lanes their bins x classes cells.
__device__ void flush_store(const Level& a, const unsigned* hs, bool unit,
                            long long lane, int f0, int nf) {
  const int bc = a.bins * a.classes;
  const int l = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < a.nodes * nf; q += kThreads / 32) {
    const int nd = q / nf;
    const int fl = q - nd * nf;
    const unsigned* src = hs + nd * a.sN + fl * a.sF;
    float* dst = a.H + ((lane * a.nodes + nd) * a.F + f0 + fl) * bc;
    for (int i = l; i < bc; i += 32) {
      const unsigned u = src[i * a.sC];
      dst[i] = unit ? static_cast<float>(u) : __uint_as_float(u);
    }
  }
}

// The tile added into the zeroed H: per node one contiguous run of
// nf * bins * classes floats, whose 16-byte-aligned middle goes by one bulk
// reduce-add (shared and global runs start at the same phase mod 4 words,
// see s0) and its unaligned ends by scalar atomics.
__device__ void flush_bulk(const Level& a, unsigned* hs, bool unit,
                           long long lane, int f0, int nf, int s0,
                           int words) {
  if (unit)
    for (int i = threadIdx.x; i < words; i += kThreads)
      hs[i] = __float_as_uint(static_cast<float>(hs[i]));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int bc = a.bins * a.classes;
  const int len = nf * bc;
  bool issued = false;
  for (int nd = threadIdx.x; nd < a.nodes; nd += kThreads) {
    const int ss = s0 + nd * a.sN;
    const long long gs = ((lane * a.nodes + nd) * a.F + f0) * bc;
    int head = static_cast<int>((4 - (gs & 3)) & 3);
    head = head < len ? head : len;
    const int mid = (len - head) & ~3;
    for (int k = 0; k < head; ++k)
      atomicAdd(a.H + gs + k, __uint_as_float(hs[ss + k]));
    for (int k = head + mid; k < len; ++k)
      atomicAdd(a.H + gs + k, __uint_as_float(hs[ss + k]));
    if (mid > 0) {
      const unsigned src = static_cast<unsigned>(
          __cvta_generic_to_shared(hs + ss + head));
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
          "[%0], [%1], %2;\n"
          :: "l"(a.H + gs + head), "r"(src), "r"(mid * 4) : "memory");
      issued = true;
    }
  }
  if (issued) {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <typename B, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) hist_kernel(const Level a) {
  extern __shared__ __align__(16) unsigned hs[];
  const int f0 = blockIdx.x * a.nf;
  const int nf = a.F - f0 < a.nf ? a.F - f0 : a.nf;
  const long long lane = blockIdx.z;
  // bulk: the shared run of node 0 starts at the global run's phase mod 4
  const int s0 = a.bulk ? static_cast<int>(
      (((lane * a.nodes) * a.F + f0) * (a.bins * a.classes)) & 3) : 0;
  const int words = s0 + a.nodes * a.sN;
  for (int i = threadIdx.x; i < words; i += kThreads) hs[i] = 0u;
  __syncthreads();

  const int row0 = blockIdx.y * a.rows;
  const int row_end = a.R - row0 < a.rows ? a.R : row0 + a.rows;
  const bool bad = walk<B, kVec, true>(a, hs, lane, f0, nf, s0, row0,
                                       row_end);
  const bool unit = !__syncthreads_or(bad);
  if (!unit) {                     // a weight other than 0 or 1: redo in float
    for (int i = threadIdx.x; i < words; i += kThreads) hs[i] = 0u;
    __syncthreads();
    walk<B, kVec, false>(a, hs, lane, f0, nf, s0, row0, row_end);
    __syncthreads();
  }
  if (a.bulk)
    flush_bulk(a, hs, unit, lane, f0, nf, s0, words);
  else
    flush_store(a, hs, unit, lane, f0, nf);
}

template <typename B, bool kVec>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream,
                   const Level& a) {
  auto kernel = hist_kernel<B, kVec>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename B>
cudaError_t launch_bins(int vec, dim3 grid, int smem, cudaStream_t stream,
                        const Level& a) {
  return vec ? launch<B, true>(grid, smem, stream, a)
             : launch<B, false>(grid, smem, stream, a);
}

}  // namespace

// node, y: (L, R) int32; xbin: (L, R, F) with unit stride along F,
// xbin_dtype 0 int32, 1 int16, 2 uint8; w: (L, R) float32; each with its
// lane and row strides.  H: (L, nodes, F, bins, classes) float32,
// contiguous, zeroed when bulk is 1.  The layout (kernels.split_hist.
// layout): nf features a tile, n_chunks row chunks a lane, the shared
// strides sN, sF, sC, smem bytes a block; vec 1 reads a row's bins as one
// 16-byte load (the caller checks that F bins fit 16 bytes and that the
// base and strides are 16-byte aligned), 0 one load an element.  Returns
// cudaGetLastError() after the launch.
extern "C" int split_hist_launch(
    const void* node, long long snl, long long snr, const void* xbin,
    int xbin_dtype, long long sxl, long long sxr, const void* y,
    long long syl, long long syr, const void* w, long long swl,
    long long swr, int L, int R, int F, int nodes, int bins, int classes,
    int nf, int n_chunks, int sN, int sF, int sC, int smem, int bulk,
    int vec, void* H, void* stream) {
  if (L < 1 || L > 65535 || R < 1 || F < 1 || nodes < 1 || bins < 1 ||
      classes < 1 || nf < 1 || n_chunks < 1 || n_chunks > 65535 ||
      sN < 1 || sF < 1 || sC < 1 || smem < 4 || smem > kMaxSmemBytes ||
      xbin_dtype < 0 || xbin_dtype > 2 || (vec != 0 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nf > F) nf = F;
  const int rows = (R + n_chunks - 1) / n_chunks;
  const int chunks = (R + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>((F + nf - 1) / nf),
                  static_cast<unsigned>(chunks), static_cast<unsigned>(L));
  const Level a{static_cast<const int*>(node), snl, snr, xbin, sxl, sxr,
                static_cast<const int*>(y), syl, syr,
                static_cast<const float*>(w), swl, swr, R, F, nodes, bins,
                classes, nf, rows, sN, sF, sC, bulk,
                static_cast<float*>(H)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (xbin_dtype == 0)
    err = launch_bins<int32_t>(vec, grid, smem, s, a);
  else if (xbin_dtype == 1)
    err = launch_bins<int16_t>(vec, grid, smem, s, a);
  else
    err = launch_bins<uint8_t>(vec, grid, smem, s, a);
  return static_cast<int>(err);
}

extern "C" const char* split_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
