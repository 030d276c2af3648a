// Hand-written Hopper (sm_90a) kernels of the node-major adjacency gather:
// the general-graph broadcast path (random-regular graphs, partitions).
//
// Bitsets are (N, W) node-major: word c of node i sits at i * W + c.  The
// adjacency is an (N, D) int32 table padded with -1; `live`, when given,
// is an (N, D) byte mask of the edges that deliver this round (absent: an
// edge delivers iff its index is >= 0, so fault-free rounds build no
// (N, D) mask).  Each kernel gives one thread one (i, c) word: thread k
// of the flat grid owns word k, so a warp's threads cover consecutive
// words, and at W = 1 consecutive nodes.
//
// - gather_or:    inbox[i, c] = OR_d (live[i,d] ? payload[nbrs[i,d], c] : 0)
//   Replaces: gossip_glomers_tpu/tpu_sim/broadcast.py _gather_or
//   (:185-205), an XLA gather per degree column.
// - sync_diff_pc: () uint32 = sum over live (i, d) and c of
//   popc(payload[nbrs[i,d], c] & ~recv[i, c]) mod 2^32.
//   Replaces: broadcast.py _sync_diff_pc (:247-264).
// - col_popcount_nm: out[i] = sum_c popc(x[i, c]), the node-major mode of
//   the per-node popcount (broadcast.py:419, :464, :542).
//
// Bound on the card: memory, and at W = 1 its latency.  Each thread reads
// its D neighbour indices (coalesced) and then D payload words at random
// rows: a warp's 32 gathered words land in 32 different sectors, so the
// kernel moves 32 bytes for every 4 it uses unless the payload sits in
// L2.  At the main path's W = 1, N = 2^20 the payload is 4 MiB and does
// (the H100's L2 is 50 MB), so the gathers are L2 hits and the kernel is
// bound by the latency of D dependent-free loads per thread, which the
// loop issues back to back.  The byte bound counts each input once: the
// payload, the (N, D) index table (8x the payload at W = 1: it is the
// largest input), the mask when given, and the output.  Padding: index -1
// is never read; an edge that is live but padded reads row 0, as the
// reference's clip-then-mask does.  sync_diff_pc sums per thread in
// uint32, reduces each warp with shuffles and each block through shared
// memory, and adds one unsigned atomicAdd per block: addition mod 2^32
// is associative and commutative, so the order of the atomics does not
// change the result.  Indices are 64-bit (N * W passes 2^31 at W = 128).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool edge_ok(const int32_t* __restrict__ nbrs,
                                        const uint8_t* __restrict__ live,
                                        int64_t e, int64_t* j,
                                        int64_t n_src) {
  const int64_t raw = __ldg(nbrs + e);
  const bool ok = live != nullptr ? __ldg(live + e) != 0 : raw >= 0;
  *j = raw < 0 ? 0 : (raw >= n_src ? n_src - 1 : raw);
  return ok;
}

template <bool kOneWord>
__device__ __forceinline__ void split(int64_t k, int64_t w, int64_t* i,
                                      int64_t* c) {
  if (kOneWord) {
    *i = k;
    *c = 0;
  } else {
    *i = k / w;
    *c = k - *i * w;
  }
}

template <bool kOneWord>
__global__ void gather_or_kernel(const uint32_t* __restrict__ payload,
                                 const int32_t* __restrict__ nbrs,
                                 const uint8_t* __restrict__ live,
                                 uint32_t* __restrict__ inbox, int64_t n,
                                 int64_t w, int64_t n_src, int d) {
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n * w) return;
  int64_t i, c;
  split<kOneWord>(k, w, &i, &c);
  uint32_t v = 0u;
  for (int e = 0; e < d; ++e) {
    int64_t j;
    if (edge_ok(nbrs, live, i * d + e, &j, n_src))
      v |= __ldg(payload + j * w + c);
  }
  inbox[k] = v;
}

template <bool kOneWord>
__global__ void sync_diff_pc_kernel(const uint32_t* __restrict__ payload,
                                    const uint32_t* __restrict__ recv,
                                    const int32_t* __restrict__ nbrs,
                                    const uint8_t* __restrict__ live,
                                    uint32_t* __restrict__ out, int64_t n,
                                    int64_t w, int64_t n_src, int d) {
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t s = 0u;
  if (k < n * w) {
    int64_t i, c;
    split<kOneWord>(k, w, &i, &c);
    const uint32_t mine = __ldg(recv + k);
    for (int e = 0; e < d; ++e) {
      int64_t j;
      if (edge_ok(nbrs, live, i * d + e, &j, n_src))
        s += __popc(__ldg(payload + j * w + c) & ~mine);
    }
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0 && s != 0u) atomicAdd(out, s);
  }
}

__global__ void col_popcount_nm_kernel(const uint32_t* __restrict__ x,
                                       int32_t* __restrict__ out, int64_t n,
                                       int64_t w) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = x + i * w;
  int32_t s = 0;
  for (int64_t c = 0; c < w; ++c) s += __popc(__ldg(row + c));
  out[i] = s;
}

unsigned blocks_for(int64_t count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() so that a
// refused launch reaches the caller.  The caller guarantees n, w, n_src,
// d >= 1, n * w < 2^31 * kThreads, device pointers to contiguous buffers
// ((n_src, w) payload, (n, w) recv and inbox, (n, d) nbrs and live), live
// either null or a byte mask, and for sync_diff_pc an `out` word that it
// zeroed on the same stream.

extern "C" int gg_gather_or(const void* payload, const void* nbrs,
                            const void* live, void* inbox, int64_t n,
                            int64_t w, int64_t n_src, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(payload);
  auto nb = static_cast<const int32_t*>(nbrs);
  auto lv = static_cast<const uint8_t*>(live);
  auto out = static_cast<uint32_t*>(inbox);
  if (w == 1)
    gather_or_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        p, nb, lv, out, n, w, n_src, d);
  else
    gather_or_kernel<false><<<blocks_for(n * w), kThreads, 0, s>>>(
        p, nb, lv, out, n, w, n_src, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_sync_diff_pc(const void* payload, const void* recv,
                               const void* nbrs, const void* live,
                               void* out, int64_t n, int64_t w,
                               int64_t n_src, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(payload);
  auto r = static_cast<const uint32_t*>(recv);
  auto nb = static_cast<const int32_t*>(nbrs);
  auto lv = static_cast<const uint8_t*>(live);
  auto o = static_cast<uint32_t*>(out);
  if (w == 1)
    sync_diff_pc_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        p, r, nb, lv, o, n, w, n_src, d);
  else
    sync_diff_pc_kernel<false><<<blocks_for(n * w), kThreads, 0, s>>>(
        p, r, nb, lv, o, n, w, n_src, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_col_popcount_nm(const void* x, void* out, int64_t n,
                                  int64_t w, void* stream) {
  col_popcount_nm_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int32_t*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}
