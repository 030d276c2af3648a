// Hand-written Hopper (sm_90a) kernel of the open-loop traffic driver's
// completion predicate: the AND over the node axis of an int32 bitset, the
// words that EVERY node holds.
//
// - and_fold, row form: a words-major (W, N) bitset to (W,), one row a
//   word.  A grid of (node chunk, row) blocks; each thread ANDs four
//   16-byte loads of its row's chunk, the warp reduces with
//   __reduce_and_sync, the block through shared memory, and thread 0 puts
//   one atomicAnd a block into the output, which the wrapper fills with all
//   ones first.  A row that does not start on a 16-byte boundary (N not a
//   multiple of 4, or a view 4 bytes into its allocation) takes its head
//   words and its ragged tail word by word in the row's first block.
// - and_fold, column form: a node-major (N, C) bitset to (C,) (C = W, or
//   K Wc for Kafka's presence viewed as (N, K Wc)).  Threads run along the
//   contiguous columns (32, 64 or 128 a row of the block, the rest of the
//   256 threads on the next rows), blocks take chunks of nodes (enough
//   chunks to fill the card: 16 blocks an SM), and one atomicAnd a
//   (block, column) goes into the output.  The wrapper sends
//   C == 1 to the row form.
//   Replaces: no Pallas kernel.  The XLA lax.reduce(..., bitwise_and) of
//   gossip_glomers_tpu/tpu_sim/broadcast.py:2559 (_traffic_done) and
//   kafka.py:1396 (_traffic_round): torch has no AND reduction.
//
// Bound on the card: bytes.  The state is read once (4 N W bytes; 201 MB
// at (768, 65536), 1 GiB at (256, 2^20)) and W words are written; a word
// costs one AND, far below the integer rate.  At 3.35 TB/s that is 0.060
// ms and 0.32 ms; a state under the L2's 50 MB is bounded at the L2's
// rate.  Design: independent 16-byte loads in flight (four a thread) for
// the row form; a warp reads 128 contiguous bytes of one node row in the
// column form; no block waits on another (atomics into an all-ones
// output, so the result is the same whatever order the blocks run in).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = 4;           // 16-byte loads a thread (rows)
constexpr int64_t kMinRowsPerBlock = 32;   // nodes a block (columns)
constexpr int64_t kColBlocks = 132 * 16;   // blocks to fill the card
constexpr int64_t kMaxGridY = 65535;

struct Args {
  const uint32_t* x;
  uint32_t* out;
  int64_t n;        // rows form: a row's length; columns form: the nodes
  int64_t c;        // columns form: the columns
  int64_t rows_per_block;
  int tx;           // columns form: threads along the columns
};

// The AND of v over the block; valid in thread 0.
__device__ __forceinline__ uint32_t block_and(uint32_t v, uint32_t* smem) {
  v = __reduce_and_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : 0xffffffffu;
    v = __reduce_and_sync(0xffffffffu, v);
  }
  return v;
}

template <bool kCols>
__global__ void __launch_bounds__(kThreads) and_fold_kernel(Args a) {
  __shared__ uint32_t smem[kThreads];
  uint32_t acc = 0xffffffffu;
  if (!kCols) {
    const int64_t n = a.n;
    const uint32_t* row = a.x + static_cast<int64_t>(blockIdx.y) * n;
    // words before the first 16-byte boundary of the row
    int64_t head =
        static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(row) & 15))
                             & 15) >> 2;
    if (head > n) head = n;
    const int64_t nvec = (n - head) >> 2;
    const uint4* vec = reinterpret_cast<const uint4*>(row + head);
    const int64_t base =
        static_cast<int64_t>(blockIdx.x) * kThreads * kVecPerThread
        + threadIdx.x;
    uint4 q[kVecPerThread];
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int64_t j = base + static_cast<int64_t>(i) * kThreads;
      q[i] = j < nvec ? __ldg(vec + j)
                      : make_uint4(~0u, ~0u, ~0u, ~0u);
    }
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i)
      acc &= q[i].x & q[i].y & q[i].z & q[i].w;
    if (blockIdx.x == 0) {
      const int64_t tail0 = head + (nvec << 2);
      const int t = threadIdx.x;
      if (t < head) acc &= __ldg(row + t);
      if (t < n - tail0) acc &= __ldg(row + tail0 + t);
    }
    acc = block_and(acc, smem);
    if (threadIdx.x == 0) atomicAnd(a.out + blockIdx.y, acc);
  } else {
    const int tx = a.tx, ty = kThreads / a.tx;
    const int lx = threadIdx.x % tx, ly = threadIdx.x / tx;
    const int64_t col = static_cast<int64_t>(blockIdx.x) * tx + lx;
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * a.rows_per_block;
    const int64_t r1 = r0 + a.rows_per_block < a.n ? r0 + a.rows_per_block
                                                   : a.n;
    if (col < a.c) {
      const uint32_t* p = a.x + col;
#pragma unroll 4
      for (int64_t r = r0 + ly; r < r1; r += ty) acc &= __ldg(p + r * a.c);
    }
    smem[threadIdx.x] = acc;
    __syncthreads();
    if (ly == 0 && col < a.c) {
      for (int k = 1; k < ty; ++k) acc &= smem[k * tx + lx];
      atomicAnd(a.out + col, acc);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// out[r] &= AND over j of x[r * n + j], r < rows: the row form.  The
// caller fills out with all ones.
extern "C" int gg_and_fold_rows(const void* x, void* out, int64_t rows,
                                int64_t n, void* stream) {
  if (rows < 0 || rows > kMaxGridY || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, 0,
         0, 0};
  const int64_t per_block = int64_t{kThreads} * kVecPerThread;
  const int64_t gx = ceil_div((n >> 2) > 0 ? (n >> 2) : 1, per_block);
  if (gx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  and_fold_kernel<false>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(rows)),
         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[j] &= AND over i < n of x[i * c + j], j < c: the column form.  The
// caller fills out with all ones.
extern "C" int gg_and_fold_cols(const void* x, void* out, int64_t n,
                                int64_t c, void* stream) {
  if (n < 0 || c < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  int tx = 32;
  while (tx < 128 && tx < c) tx <<= 1;
  const int ty = kThreads / tx;
  const int64_t gx = ceil_div(c, tx);
  // enough node chunks that the grid fills the card, each at least
  // kMinRowsPerBlock nodes, within grid.y's limit
  const int64_t want_gy = ceil_div(kColBlocks, gx);
  int64_t rpb = ceil_div(n, want_gy);
  if (rpb < kMinRowsPerBlock) rpb = kMinRowsPerBlock;
  if (rpb < ceil_div(n, kMaxGridY)) rpb = ceil_div(n, kMaxGridY);
  rpb = ceil_div(rpb, ty) * ty;
  const int64_t gy = ceil_div(n, rpb);
  if (gx > 0x7fffffff || gy > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, c,
         rpb, tx};
  and_fold_kernel<true>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
