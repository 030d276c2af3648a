// Hand-written Hopper (sm_90a) kernels of the words-major shift
// topologies: circulant, ring, line and grid.
//
// Bitsets are (W, N) words-major: word w of node i sits at w * N + i.
// Every one of these topologies delivers node i's inbox as the OR over a
// small table of directions, each a constant node offset:
//
//   inbox[w, i] = OR_d  payload[w, j_d(i)]   where j_d(i) = i + off_d
//
// A direction either wraps (ring and circulant rotations: off is taken
// mod n on the host, so j < 2n and one subtraction brings it back) or
// shifts with zero fill (line and grid: j outside [0, n) delivers
// nothing).  Grid left/right directions also carry a column mask, which
// kills the row wrap-around: "left" (off +1) only where i % cols <
// cols - 1, "right" (off -1) only where i % cols > 0.
//
// Replaces: the XLA code of gossip_glomers_tpu/tpu_sim/structured.py
// grid_terms / grid_exchange, line_terms / line_exchange, ring_exchange
// and circulant_exchange (:170-222), each a few rolls or shifted
// concatenations ORed together, and the _flood_loop body over them
// (broadcast.py:285-289).  No Pallas kernel stood there.
//
// Bound on the card: memory bytes.  A word costs a handful of integer
// operations per direction against 4 bytes moved; the exchange must read
// the payload once and write the inbox once (2 bitsets), the fused round
// reads frontier and received and writes received and the next frontier
// (4 bitsets).  The design keeps every access coalesced: the offset of a
// direction is the same for every thread, so a warp's 32 consecutive
// nodes read 32 consecutive payload words for each direction.  A payload
// row (4 MiB at N = 2^20) stays in the 50 MB L2 while its blocks run, so
// device memory sees each payload word about once, but L2 serves it once
// per direction: the circulant's 8 far-apart rotations read each word 8
// times from L2 (ring, line and grid offsets are close, and L1 serves
// most repeats), which is what holds this kernel above its byte bound.
// The direction table rides in the kernel's parameters (by value, at
// most kMaxDirs entries), so it costs no memory traffic.  Offsets and
// indices are 64-bit: W * N passes 2^31 at the main path's W = 128,
// N = 2^20.  received is updated in place (word i reads and writes only
// its own received word); the next frontier goes to a second buffer,
// because word i reads its neighbours' frontier words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDirs = 16;

// direction flags
constexpr int kWrap = 1;       // rotate mod n (else zero fill)
constexpr int kMaskLeft = 2;   // only where i % cols < cols - 1
constexpr int kMaskRight = 4;  // only where i % cols > 0

struct DirTable {
  int64_t off[kMaxDirs];
  int32_t flags[kMaxDirs];
  int32_t count;
  int64_t cols;
};

__device__ __forceinline__ uint32_t shift_inbox(
    const uint32_t* __restrict__ row, int64_t i, int64_t n,
    const DirTable& t) {
  const int64_t col = t.cols > 0 ? i % t.cols : 0;
  uint32_t v = 0u;
#pragma unroll 4
  for (int d = 0; d < t.count; ++d) {
    const int f = t.flags[d];
    int64_t j = i + t.off[d];
    if (f & kWrap) {
      if (j >= n) j -= n;
    } else if (j < 0 || j >= n) {
      continue;
    }
    if ((f & kMaskLeft) && col >= t.cols - 1) continue;
    if ((f & kMaskRight) && col == 0) continue;
    v |= __ldg(row + j);
  }
  return v;
}

__global__ void shift_exchange_kernel(const uint32_t* __restrict__ payload,
                                      uint32_t* __restrict__ inbox,
                                      int64_t n, const DirTable t) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  inbox[base + i] = shift_inbox(payload + base, i, n, t);
}

__global__ void shift_flood_round_kernel(
    uint32_t* __restrict__ received, const uint32_t* __restrict__ frontier,
    uint32_t* __restrict__ frontier_next, int64_t n, const DirTable t) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const uint32_t rec = received[base + i];
  const uint32_t fresh = shift_inbox(frontier + base, i, n, t) & ~rec;
  received[base + i] = rec | fresh;
  frontier_next[base + i] = fresh;
}

dim3 node_grid(int64_t n, int64_t rows) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows));
}

// Copies the host direction table into the by-value kernel parameter.
// Returns false when it does not fit.
bool make_table(const int64_t* off, const int32_t* flags, int count,
                int64_t cols, DirTable* t) {
  if (count < 0 || count > kMaxDirs) return false;
  for (int d = 0; d < kMaxDirs; ++d) {
    t->off[d] = d < count ? off[d] : 0;
    t->flags[d] = d < count ? flags[d] : 0;
  }
  t->count = count;
  t->cols = cols;
  return true;
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a table above kMaxDirs) so that a refused
// launch reaches the caller.  The caller guarantees w, n >= 1,
// w <= 65535, device pointers to contiguous (w, n) int32 buffers, host
// pointers `off` and `flags` to `count` entries, wrap offsets in [0, n)
// and cols >= 1 wherever a column mask is set.

extern "C" int gg_shift_exchange(const void* payload, void* inbox, int64_t w,
                                 int64_t n, const int64_t* off,
                                 const int32_t* flags, int count,
                                 int64_t cols, void* stream) {
  DirTable t;
  if (!make_table(off, flags, count, cols, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  shift_exchange_kernel<<<node_grid(n, w), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload), static_cast<uint32_t*>(inbox),
      n, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_shift_flood_round(void* received, const void* frontier,
                                    void* frontier_next, int64_t w,
                                    int64_t n, const int64_t* off,
                                    const int32_t* flags, int count,
                                    int64_t cols, void* stream) {
  DirTable t;
  if (!make_table(off, flags, count, cols, &t))
    return static_cast<int>(cudaErrorInvalidValue);
  shift_flood_round_kernel<<<node_grid(n, w), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(received),
      static_cast<const uint32_t*>(frontier),
      static_cast<uint32_t*>(frontier_next), n, t);
  return static_cast<int>(cudaGetLastError());
}
