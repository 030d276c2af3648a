// Hand-written Hopper (sm_90a) kernels of the words-major k-ary tree flood.
//
// Bitsets are (W, N) words-major: word w of node i sits at w * N + i, so
// the node axis is contiguous.  In the heap-ordered k-ary tree node i's
// parent is (i - 1) / k and its children are k*i + 1 .. k*i + k (those
// below N).  Each kernel gives one thread one (w, i) word: grid.x walks
// the node axis in blocks of kThreads, grid.y the W words.
//
// Replaces: benchmarks/pallas_tree_probe.py make_pallas_exchange's inner
// `kernel` (the fused 4-ary tree inbox, the form of
// gossip_glomers_tpu/tpu_sim/structured.py tree_exchange), which Mosaic
// never lowered: its 4:1 child compress is here a plain strided load.
//
// Bound on the card: memory bytes.  Each word is a handful of integer
// operations against 4 bytes moved, far below the card's operation rate,
// so the least time is the bytes over the HBM rate (3.35 TB/s on an H100
// SXM).  tree_exchange reads the payload once and writes the inbox once
// (2 bitsets), tree_flood_round reads frontier and received and writes
// received and the next frontier (4 bitsets), col_popcount reads one
// bitset and writes N counts.  The design keeps every access coalesced: a
// warp's 32 consecutive nodes read 32 consecutive received words, a span
// of 32 * k consecutive child words (the k loads per thread stride by k
// words, so each load instruction touches the same cache lines its
// neighbours do and L1 serves the repeats), and 32 / k parent words.
// The children of node i start at k*i + 1, which is not 16-byte aligned,
// so the loads are scalar.  Offsets are 64-bit: W * N passes 2^31 at the
// main path's W = 128, N = 2^20.  received is updated in place (word i
// reads and writes only its own received word); the frontier is read
// from one buffer and written to another, because word i reads its
// neighbours' frontier words, which other blocks would be overwriting.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t tree_inbox(
    const uint32_t* __restrict__ row, int64_t i, int64_t n, int k) {
  uint32_t v = i > 0 ? __ldg(row + (i - 1) / k) : 0u;
  int64_t c = static_cast<int64_t>(k) * i + 1;
  const int64_t end = c + k < n ? c + k : n;
  for (; c < end; ++c) v |= __ldg(row + c);
  return v;
}

__global__ void tree_exchange_kernel(const uint32_t* __restrict__ payload,
                                     uint32_t* __restrict__ inbox,
                                     int64_t n, int k) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  inbox[base + i] = tree_inbox(payload + base, i, n, k);
}

__global__ void tree_flood_round_kernel(uint32_t* __restrict__ received,
                                        const uint32_t* __restrict__ frontier,
                                        uint32_t* __restrict__ frontier_next,
                                        int64_t n, int k) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const uint32_t rec = received[base + i];
  const uint32_t fresh = tree_inbox(frontier + base, i, n, k) & ~rec;
  received[base + i] = rec | fresh;
  frontier_next[base + i] = fresh;
}

__global__ void col_popcount_kernel(const uint32_t* __restrict__ x,
                                    int32_t* __restrict__ out,
                                    int64_t w, int64_t n) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t s = 0;
  for (int64_t r = 0; r < w; ++r) s += __popc(__ldg(x + r * n + i));
  out[i] = s;
}

dim3 node_grid(int64_t n, int64_t rows) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows));
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() so that a
// refused launch reaches the caller.  The caller guarantees w, n >= 1,
// w <= 65535, and device pointers to contiguous (w, n) int32 buffers.

extern "C" int gg_tree_exchange(const void* payload, void* inbox, int64_t w,
                                int64_t n, int k, void* stream) {
  tree_exchange_kernel<<<node_grid(n, w), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload), static_cast<uint32_t*>(inbox),
      n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_tree_flood_round(void* received, const void* frontier,
                                   void* frontier_next, int64_t w, int64_t n,
                                   int k, void* stream) {
  tree_flood_round_kernel<<<node_grid(n, w), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(received),
      static_cast<const uint32_t*>(frontier),
      static_cast<uint32_t*>(frontier_next), n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_col_popcount(const void* x, void* out, int64_t w,
                               int64_t n, void* stream) {
  col_popcount_kernel<<<node_grid(n, 1), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int32_t*>(out), w, n);
  return static_cast<int>(cudaGetLastError());
}
