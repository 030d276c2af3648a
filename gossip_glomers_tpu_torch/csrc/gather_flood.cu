// Hand-written Hopper (sm_90a) kernels of the node-major adjacency gather:
// the general-graph broadcast path (random-regular graphs, partitions).
//
// Bitsets are (N, W) node-major: word c of node i sits at i * W + c.  The
// adjacency is an (N, D) int32 table padded with -1; `live`, when given,
// is an (N, D) byte mask of the edges that deliver this round (absent: an
// edge delivers iff its index is >= 0, so fault-free rounds build no
// (N, D) mask).  Indices are clipped into the payload's rows before the
// mask applies (an edge that is live but padded reads row 0), as the
// reference's clip-then-mask does.
//
// - gather_or:          inbox[i, c] = OR_d (live[i,d] ? payload[nbrs[i,d], c] : 0)
//   Replaces: gossip_glomers_tpu/tpu_sim/broadcast.py _gather_or
//   (:185-205), an XLA gather per degree column.
// - gather_flood_round: new = gather_or(payload, nbrs, live) & ~rec and
//   rec_next = rec | new, out of place (on sync rounds the payload IS
//   rec, so an in-place update would let bits travel two hops).
//   Replaces: the gather round's delivery, broadcast.py :558 and :579-580.
// - sync_diff_pc:       () uint32 = sum over live (i, d) and c of
//   popc(payload[nbrs[i,d], c] & ~recv[i, c]) mod 2^32.
//   Replaces: broadcast.py _sync_diff_pc (:247-264).
// - col_popcount_nm:    out[i] = sum_c popc(x[i, c]), the node-major mode
//   of the per-node popcount (broadcast.py:419, :464, :542).
//
// Bound on the card.  The byte bound counts each input once: the payload,
// the (N, D) index table (8x the payload at the main path's W = 1, D = 8:
// the largest input), the mask when given, recv, and the outputs.  What
// the card must really serve is one random payload row per edge: at
// W = 1 a 4-byte word, for which L1 and L2 move a whole 32-byte sector,
// and a warp's 32 such reads touch 32 different lines.  At N = 2^20 the
// 4 MiB payload sits in the 50 MB L2, and the rate at which L1 and L2
// serve random sectors sets the time: a probe that does nothing but these
// reads takes 0.064-0.068 ms on an H100 (PERF.md).  At W = 128 a row is
// 512 bytes and every edge reads one from HBM.
//
// Design: one gather core for the three kernels.  Each node row gets a
// lane group: at W = 1 a thread per node; when W % 4 == 0 and the rows
// are 16-byte aligned, a lane per 16-byte vector of the row, up to a warp
// per node (W = 128); else a lane per word.  The group loads the node's
// indices from global memory (D = 8: two 16-byte vectors when aligned,
// its live bytes one 8-byte vector), issues all D payload loads of a unit
// before any OR (D is a template parameter: an instance for D = 8, a
// generic one that takes any D four edges at a time), and writes
// coalesced.  Node indices are 32-bit (N < 2^31), word offsets 64-bit
// (N * W passes 2^31 at W = 128).  No shared-memory staging: a TMA-staged
// variant of the same core (index and recv tiles brought by bulk copies
// from a producer warp through mbarrier stages of persistent blocks) was
// measured 1.1-5.9% slower at both main shapes, the tile quantization of
// its persistent blocks, which a grid of short blocks does not have
// (PERF.md).  sync_diff_pc sums per thread in uint32, reduces each warp
// with shuffles and the block through shared memory, and adds one
// unsigned atomicAdd per block (its grid is capped at kSyncBlocks, its
// blocks loop): addition mod 2^32 is associative and commutative, so the
// order of the atomics does not change the result.  Any contiguous
// 4-byte aligned view is taken: the vector loads are used only where the
// addresses allow them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSyncBlocks = 4096;

enum Op { kGatherOr, kSyncDiff, kFloodRound };

struct Args {
  const uint32_t* payload;  // (n_src, w)
  const int32_t* nbrs;      // (n, d)
  const uint8_t* live;      // (n, d), or null
  const uint32_t* recv;     // (n, w): sync_diff_pc's recv, the round's rec
  uint32_t* out;            // inbox, the round's new, or the diff's sum
  uint32_t* rec_out;        // the round's rec | new
  int32_t n, n_src, d;
  int32_t units;            // units of a row: W words, or W / 4 vectors
  int32_t group_log2;       // lanes per node row: 1 << group_log2 (<= 32)
  bool idx_vec;             // D = 8 index rows 16-byte aligned
  bool live_vec;            // D = 8 live rows 8-byte aligned
};

// A unit of a node row: one word, or one 16-byte vector.
template <bool kVec>
struct UnitOf {
  using T = uint32_t;
};
template <>
struct UnitOf<true> {
  using T = uint4;
};

__device__ __forceinline__ uint32_t zero_unit(uint32_t) { return 0u; }
__device__ __forceinline__ uint4 zero_unit(uint4) {
  return make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ uint32_t or_unit(uint32_t x, uint32_t y) {
  return x | y;
}
__device__ __forceinline__ uint4 or_unit(uint4 x, uint4 y) {
  return make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
}
__device__ __forceinline__ uint32_t andnot_unit(uint32_t x, uint32_t y) {
  return x & ~y;
}
__device__ __forceinline__ uint4 andnot_unit(uint4 x, uint4 y) {
  return make_uint4(x.x & ~y.x, x.y & ~y.y, x.z & ~y.z, x.w & ~y.w);
}
__device__ __forceinline__ uint32_t popc_unit(uint32_t x) {
  return static_cast<uint32_t>(__popc(x));
}
__device__ __forceinline__ uint32_t popc_unit(uint4 x) {
  return static_cast<uint32_t>(__popc(x.x) + __popc(x.y) + __popc(x.z)
                               + __popc(x.w));
}

// Edges [e0, e0 + kChunk) of node i: clipped source rows and whether each
// delivers (false past the degree).
template <int kD, int kChunk>
__device__ __forceinline__ void edges(const Args& a, int32_t i, int e0,
                                      int d, int32_t (&j)[kChunk],
                                      bool (&ok)[kChunk]) {
  const int64_t at = static_cast<int64_t>(i) * d + e0;
  int32_t raw[kChunk];
  if (kD == 8 && a.idx_vec) {
    const int4* v = reinterpret_cast<const int4*>(a.nbrs + at);
    const int4 lo = __ldg(v), hi = __ldg(v + 1);
    const int32_t all[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int q = 0; q < kChunk; ++q) raw[q] = all[q];
  } else {
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      raw[q] = (kD > 0 || e0 + q < d) ? __ldg(a.nbrs + at + q) : -1;
  }
  if (a.live != nullptr) {
    if (kD == 8 && a.live_vec) {
      const uint2 m = __ldg(reinterpret_cast<const uint2*>(a.live + at));
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        ok[q] = ((q < 4 ? m.x >> (8 * q) : m.y >> (8 * (q - 4))) & 0xFFu)
                != 0u;
    } else {
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        ok[q] = (kD > 0 || e0 + q < d) && __ldg(a.live + at + q) != 0;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kChunk; ++q) ok[q] = raw[q] >= 0;
  }
#pragma unroll
  for (int q = 0; q < kChunk; ++q)
    j[q] = raw[q] < 0 ? 0 : (raw[q] >= a.n_src ? a.n_src - 1 : raw[q]);
}

// sync_diff_pc's block reduction: one atomicAdd.
__device__ __forceinline__ void add_block_sum(uint32_t s, uint32_t* out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0 && s != 0u) atomicAdd(out, s);
  }
}

// The gather core: the block's lane groups walk the nodes (one pass, or
// several when the grid is capped), each lane its units of the row.
// kOne: W = 1, a thread per node and nothing else to walk.
template <Op kOp, bool kVec, bool kOne, int kD>
__device__ __forceinline__ void gather_rows(const Args& a) {
  using U = typename UnitOf<kVec>::T;
  constexpr int kChunk = kD > 0 ? kD : 4;
  const int glog = kOne ? 0 : a.group_log2;
  const int group = 1 << glog;
  const int lane_g = kOne ? 0 : threadIdx.x & (group - 1);
  const int per_block = kThreads >> glog;
  const int32_t units = kOne ? 1 : a.units;
  const int d = kD > 0 ? kD : a.d;
  const U* payload = reinterpret_cast<const U*>(a.payload);
  const U* recv = reinterpret_cast<const U*>(a.recv);
  U* out = reinterpret_cast<U*>(a.out);
  U* rec_out = reinterpret_cast<U*>(a.rec_out);
  uint32_t sum = 0u;
  for (int64_t node = static_cast<int64_t>(blockIdx.x) * per_block
                      + (threadIdx.x >> glog);
       node < a.n; node += static_cast<int64_t>(gridDim.x) * per_block) {
    const int32_t i = static_cast<int32_t>(node);
    const int64_t row = static_cast<int64_t>(i) * units;
    for (int c = lane_g; c < units; c += group) {
      U mine = zero_unit(U{});
      if (kOp != kGatherOr) mine = __ldg(recv + row + c);
      U acc = zero_unit(U{});
      for (int e0 = 0; e0 < d; e0 += kChunk) {
        int32_t j[kChunk];
        bool ok[kChunk];
        edges<kD, kChunk>(a, i, e0, d, j, ok);
        U x[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          x[q] = ok[q] ? __ldg(payload + static_cast<int64_t>(j[q]) * units
                               + c)
                       : zero_unit(U{});
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          if (kOp == kSyncDiff)
            sum += popc_unit(andnot_unit(x[q], mine));
          else
            acc = or_unit(acc, x[q]);
        }
      }
      if (kOp == kGatherOr) {
        out[row + c] = acc;
      } else if (kOp == kFloodRound) {
        const U fresh = andnot_unit(acc, mine);
        out[row + c] = fresh;
        rec_out[row + c] = or_unit(mine, fresh);
      }
    }
  }
  if (kOp == kSyncDiff) add_block_sum(sum, a.out);
}

// One __global__ per entry point, so that a profile names each; the W = 1
// instances compiled for full occupancy (8 blocks an SM).
template <bool kVec, bool kOne, int kD>
__global__ void __launch_bounds__(kThreads, kOne ? 8 : 4)
    gather_or_kernel(const Args a) {
  gather_rows<kGatherOr, kVec, kOne, kD>(a);
}

template <bool kVec, bool kOne, int kD>
__global__ void __launch_bounds__(kThreads, kOne ? 8 : 4)
    sync_diff_pc_kernel(const Args a) {
  gather_rows<kSyncDiff, kVec, kOne, kD>(a);
}

template <bool kVec, bool kOne, int kD>
__global__ void __launch_bounds__(kThreads, kOne ? 8 : 4)
    gather_flood_round_kernel(const Args a) {
  gather_rows<kFloodRound, kVec, kOne, kD>(a);
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

using Kernel = void (*)(const Args);

template <Op kOp, bool kVec, bool kOne, int kD>
Kernel kernel_of() {
  if constexpr (kOp == kGatherOr) return gather_or_kernel<kVec, kOne, kD>;
  else if constexpr (kOp == kSyncDiff)
    return sync_diff_pc_kernel<kVec, kOne, kD>;
  else return gather_flood_round_kernel<kVec, kOne, kD>;
}

template <Op kOp, int kD>
Kernel pick_d(bool vec, bool one) {
  return vec ? kernel_of<kOp, true, false, kD>()
             : one ? kernel_of<kOp, false, true, kD>()
                   : kernel_of<kOp, false, false, kD>();
}

template <Op kOp>
Kernel pick(bool vec, bool one, bool d8) {
  return d8 ? pick_d<kOp, 8>(vec, one) : pick_d<kOp, 0>(vec, one);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Lanes per node row, as a power of two: one per unit, at most a warp.
int group_log2_of(int64_t units) {
  int g = 0;
  while ((int64_t{1} << g) < (units < 32 ? units : 32)) ++g;
  return g;
}

int launch(Op op, const void* payload, const void* nbrs, const void* live,
           const void* recv, void* out, void* rec_out, int64_t n, int64_t w,
           int64_t n_src, int d, void* stream) {
  // node indices are 32-bit
  if (n < 1 || n_src < 1 || d < 1 || w < 1 || n >= (int64_t{1} << 31)
      || n_src >= (int64_t{1} << 31) || w >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.payload = static_cast<const uint32_t*>(payload);
  a.nbrs = static_cast<const int32_t*>(nbrs);
  a.live = static_cast<const uint8_t*>(live);
  a.recv = static_cast<const uint32_t*>(recv);
  a.out = static_cast<uint32_t*>(out);
  a.rec_out = static_cast<uint32_t*>(rec_out);
  a.n = static_cast<int32_t>(n);
  a.n_src = static_cast<int32_t>(n_src);
  a.d = d;
  const bool vec = w % 4 == 0 && aligned(payload, 16)
                   && (op == kSyncDiff || aligned(out, 16))
                   && (op == kGatherOr || aligned(recv, 16))
                   && (op != kFloodRound || aligned(rec_out, 16));
  a.units = static_cast<int32_t>(vec ? w / 4 : w);
  a.group_log2 = group_log2_of(a.units);
  a.idx_vec = d == 8 && aligned(nbrs, 16);
  a.live_vec = d == 8 && aligned(live, 8);
  const int per_block = kThreads >> a.group_log2;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (op == kSyncDiff && blocks > kSyncBlocks) blocks = kSyncBlocks;
  const bool one = w == 1, d8 = d == 8;
  const Kernel k = op == kGatherOr ? pick<kGatherOr>(vec, one, d8)
                   : op == kSyncDiff ? pick<kSyncDiff>(vec, one, d8)
                                     : pick<kFloodRound>(vec, one, d8);
  k<<<static_cast<unsigned>(blocks), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

unsigned blocks_for(int64_t count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it cannot take) so that a refused
// launch reaches the caller.  The caller guarantees device pointers to
// contiguous, 4-byte aligned buffers ((n_src, w) payload, (n, w) recv and
// outputs, (n, d) nbrs and live), live either null or a byte mask, and
// for sync_diff_pc an `out` word that it zeroed on the same stream.

extern "C" int gg_gather_or(const void* payload, const void* nbrs,
                            const void* live, void* inbox, int64_t n,
                            int64_t w, int64_t n_src, int d, void* stream) {
  return launch(kGatherOr, payload, nbrs, live, nullptr, inbox, nullptr, n,
                w, n_src, d, stream);
}

extern "C" int gg_sync_diff_pc(const void* payload, const void* recv,
                               const void* nbrs, const void* live,
                               void* out, int64_t n, int64_t w,
                               int64_t n_src, int d, void* stream) {
  return launch(kSyncDiff, payload, nbrs, live, recv, out, nullptr, n, w,
                n_src, d, stream);
}

extern "C" int gg_gather_flood_round(const void* payload, const void* rec,
                                     const void* nbrs, const void* live,
                                     void* new_out, void* rec_out,
                                     int64_t n, int64_t w, int64_t n_src,
                                     int d, void* stream) {
  return launch(kFloodRound, payload, nbrs, live, rec, new_out, rec_out, n,
                w, n_src, d, stream);
}

// Nodes a block of the three gather kernels serves at W words a node, on
// rows the vector path takes when `vec` (kernels.gather_nodes_per_block
// computes the same on the host; the card tests hold the two equal).
extern "C" int gg_gather_nodes_per_block(int64_t w, int vec) {
  return kThreads >> group_log2_of(vec && w % 4 == 0 ? w / 4 : w);
}

extern "C" int gg_col_popcount_nm(const void* x, void* out, int64_t n,
                                  int64_t w, void* stream) {
  col_popcount_nm_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int32_t*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}
