// Hand-written Hopper (sm_90a) kernels of the words-major k-ary tree flood.
//
// Bitsets are (W, N) words-major: word w of node i sits at w * N + i, so
// the node axis is contiguous.  In the heap-ordered k-ary tree node i's
// parent is (i - 1) / k and its children are k*i + 1 .. k*i + k (those
// below N).  Each kernel gives one thread one (w, i) word (the k = 4
// paths of tree_exchange and tree_ring_exchange four): grid.x walks the
// node axis in blocks of kThreads,
// grid.y the W words.
//
// Replaces: benchmarks/pallas_tree_probe.py make_pallas_exchange's inner
// `kernel` (the fused 4-ary tree inbox, the form of
// gossip_glomers_tpu/tpu_sim/structured.py tree_exchange), which Mosaic
// never lowered: its 4:1 child compress is here a plain strided load.
// tree_masked_exchange is that inbox under per-edge liveness, the
// reference's XLA structured.py tree_masked_exchange (:662) and the tree
// branch of _nem_closures' exchange (:1752-1755): the parent's word is
// taken where the receiver's bit of the "parent" row is set, and child
// c's word where c's bit of the "kids" row is set (before the k:1 fold).
// Both rows are packed bits, (N + 31) / 32 words, node i at bit i % 32 of
// word i / 32: at W = 1 they move 1/16 of the bytes the bitsets do.
//
// Bound on the card: memory bytes.  Each word is a handful of integer
// operations against 4 bytes moved, far below the card's integer rate (64
// lanes a clock an SM: 16.7e12 a second on an H100 SXM at 1.98 GHz), so
// the least time is the bytes over the HBM rate (3.35 TB/s).  tree_exchange reads the payload once and writes the inbox once
// (2 bitsets), tree_flood_round reads frontier and received and writes
// received and the next frontier (4 bitsets), col_popcount reads one
// bitset and writes N counts; tree_masked_exchange moves the exchange's 2
// bitsets and the two packed rows (N / 4 bytes).  The design keeps every
// access coalesced: a warp's 32 consecutive nodes read 32 consecutive
// received words, a span
// of 32 * k consecutive child words (the k loads per thread stride by k
// words, so each load instruction touches the same cache lines its
// neighbours do and L1 serves the repeats), and 32 / k parent words.
// The children of node i start at k*i + 1, which is not 16-byte aligned,
// so the loads are scalar, except in tree_exchange's k = 4 path below.
// Offsets are 64-bit: W * N passes 2^31 at the
// main path's W = 128, N = 2^20.  received is updated in place (word i
// reads and writes only its own received word); the frontier is read
// from one buffer and written to another, because word i reads its
// neighbours' frontier words, which other blocks would be overwriting.
//
// tree_masked_exchange's liveness bits.  Its first design gave each
// thread a bit test per edge: a global load of the bit's word guarding,
// through a branch, the payload load it masked (k + 1 of each a thread).
// At (1, 2^20), k = 4, it took 0.00626 ms against a 0.00258 ms bound, 16%
// over the unmasked tree_exchange (0.0054) in the same run (NVIDIA H100
// 80GB HBM3, 700.00 W, chip_smoke.py): every payload load waited for a
// bit load, and the 32 lanes of a warp loaded the same few words 5 times
// over.  Now a warp loads its parent word and its k + 1 kids words once,
// spreads the bits by shuffles, and starts every payload load at once,
// ANDed with its bit (tree_masked_exchange_kernel); k = 4, the main
// path's, is a template, so the parent's index is a shift.  It takes
// 0.0053-0.0056 ms at (1, 2^20), as the unmasked tree_exchange does, and
// 0.648-0.653 ms at (128, 2^20), 1.05x tree_exchange (same card).
//
// tree_exchange, four nodes a thread.  A thread a word took 0.0053 ms at
// (1, 2^20) against a 0.0025 ms bound and 0.617 ms at (128, 2^20) against
// 0.321 (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py): five scalar
// loads and a store a word, 4,096 blocks a row, so each thread's and
// block's own cost set the time, not the bytes.  For k = 4 (the main
// path's), N % 4 == 0 and 16-byte aligned rows, a thread now writes four
// inbox words as one 16-byte store from four aligned 16-byte child loads,
// one child word and two parent words (quads_inbox): 0.0028 ms
// and 0.353 ms (89% and 91% of the bound, same card).  A grid of resident
// blocks striding over the quads took 0.0028 and 0.466-0.508 ms: one
// pass stays.  Any other k, view or N takes the thread-a-word kernel.
//
// tree_ring_exchange, the ring mode (per-hop latency).  The reference's
// delayed tree delivery (structured.py _delayed_impl :1038 and
// make_edge_delayed :1335, and _round_wm_nem's delayed branch,
// broadcast.py:858-881) ORs one from-parent or from-kids term a table
// entry, each read from its own slot of the (L, W, N) payload ring (the
// payload of the entry's send round) and gated by its own packed row:
// the Pallas kernel's inbox, one slot a term.  Bound: the bytes, each
// slot read once, each row once, the inbox written once (at (1, 2^20),
// two slots and four rows: 13 MB).  For k = 4 on n % 4 == 0 and a
// 16-byte aligned ring and inbox (the main path's case) a thread takes
// four nodes (ring_quads): an entry's child words come as quads_inbox's
// four 16-byte loads and a word, its bits by one funnel shift of two row
// words, its parent words q - 1 and q under four receiver bits, and the
// four inbox words stay in registers over the table and go out as one
// 16-byte store.  At (1, 2^20) it takes 0.00485 ms and at (128, 2^20)
// 0.585 ms, 81% and 82% of the bound (NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py).  Any other k, n or view takes a node a thread (the
// kernel's first form): tree_masked_exchange_kernel's warp-shared
// liveness words and shuffles, once an entry, the entry loop uniform
// across the block (every lane takes part in each entry's shuffles), one
// inbox word in a register over all entries.  A table of more than 16
// entries is split by the wrapper, the inboxes ORed.

// tree_halo_pack and tree_halo_round, the halo exchange's shard-local
// work on a mesh (one rank a shard of B consecutive nodes, k | B).  The
// reference's sharded tree exchange (structured.py tree_parent_payload
// :225, tree_sharded_exchange :261, tree_kids_payload :290) is the Pallas
// kernel's inbox cut at shard edges: a shard's parents sit in one
// (B/k + 1)-column slice of one other shard, its kids' words come back as
// partial ORs of B/k + 1 columns from up to k child shards.  The slices
// travel between ranks (torch.distributed, outside the kernels); what is
// left on the card is two index-mapping passes.  tree_halo_pack writes the
// partial a shard sends up: column 0 of the block, then the k:1 OR of
// columns 1 .. B - 1 (zero-padded to a multiple of k), each column first
// gated by its bit of a packed liveness row where one is given (the
// masked halo exchange, :765-773).  tree_halo_round reads the received
// parent slice `buf` (W, B/k + 1), the kids' landing buffer `ek` (W, B + 1)
// and the back-folded column (W): inbox[:, c] = buf[:, ceil(c / k)] (gated
// by the receiver's bit) | ek[:, c + 1], the back column ORed into column
// B - 1; its fused form is tree_flood_round's update (received in place,
// the new frontier to another buffer).  A thread a word, the simple first
// design: each output word is read from at most k + 2 inputs that
// neighbouring threads share, so the accesses coalesce.  Bound: the bytes
// (pack reads the block and writes B/k + 1 columns; the round reads buf,
// ek and received and writes the inbox, or received and the frontier).
// Their times are in PERF.md.

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

// The 4-ary inbox, four nodes a thread: thread q of a row writes inbox
// words 4q .. 4q+3 as one 16-byte store.  Their children are words 16q+1
// .. 16q+16, read as the aligned vectors at 16q, 16q+4, 16q+8 and 16q+12
// and the word 16q+16; their parents are words q - 1 (node 4q, q >= 1)
// and q.  n % 4 == 0 and 16-byte aligned rows (the wrapper's condition),
// so a vector lies wholly inside or wholly past the row: each load is
// guarded by its first word.
__device__ __forceinline__ void quads_inbox(const uint32_t* __restrict__ row,
                                            uint32_t* __restrict__ out,
                                            int64_t q, int64_t n) {
  const uint4* vrow = reinterpret_cast<const uint4*>(row);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int64_t c = 16 * q;               // the first child word, less 1
  const uint4 v0 = c < n ? __ldg(vrow + 4 * q) : zero;
  const uint4 v1 = c + 4 < n ? __ldg(vrow + 4 * q + 1) : zero;
  const uint4 v2 = c + 8 < n ? __ldg(vrow + 4 * q + 2) : zero;
  const uint4 v3 = c + 12 < n ? __ldg(vrow + 4 * q + 3) : zero;
  const uint32_t last = c + 16 < n ? __ldg(row + c + 16) : 0u;
  const uint32_t up = __ldg(row + q);
  const uint32_t up0 = q > 0 ? __ldg(row + q - 1) : 0u;
  reinterpret_cast<uint4*>(out)[q] =
      make_uint4(up0 | v0.y | v0.z | v0.w | v1.x,
                 up | v1.y | v1.z | v1.w | v2.x,
                 up | v2.y | v2.z | v2.w | v3.x,
                 up | v3.y | v3.z | v3.w | last);
}

// The inbox of one row (gridDim.y rows): a thread a word for any k, or
// (kQuads) a thread a quad for k = 4 (quads_inbox).
template <bool kQuads>
__global__ void __launch_bounds__(kThreads) tree_exchange_kernel(
    const uint32_t* __restrict__ payload, uint32_t* __restrict__ inbox,
    int64_t n, int k) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!kQuads) {
    if (i < n) inbox[base + i] = tree_inbox(payload + base, i, n, k);
  } else if (i < n >> 2) {
    quads_inbox(payload + base, inbox + base, i, n);
  }
}

// The masked inbox.  Thread i of a warp takes node i = 32m + lane, so the
// warp's liveness bits lie in few words: its receivers' parent bits in
// word m of the parent row, its children k*32m + 1 .. k*32m + 32k in
// words km .. km + k of the kids row.  Lanes 0..k load those k + 1 words
// in one coalesced instruction and each lane takes its k bits, at bit
// k*lane + 1 of them, by two shuffles and a funnel shift (k <= 31; a
// wider node's bits span more words than a warp has lanes, so there each
// child's word is loaded).  No payload load waits for a liveness load:
// each is ANDed with its bit spread to a mask.  K > 0 fixes the
// branching at compile time (the parent's index is then a shift for
// K = 4); K = 0 reads it from k.
template <int K>
__global__ void tree_masked_exchange_kernel(
    const uint32_t* __restrict__ payload, const uint32_t* __restrict__ live_p,
    const uint32_t* __restrict__ live_k, uint32_t* __restrict__ inbox,
    int64_t n, int k_arg) {
  const int k = K > 0 ? K : k_arg;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t m = i >> 5;                 // the same for the whole warp
  const int64_t nw = (n + 31) >> 5;
  // every lane of the warp takes part in the shuffles, also past n
  uint32_t parent = 0u, kids = 0u;
  if (m < nw) parent = __ldg(live_p + m);   // one request for the warp
  if (k <= 31) {
    const int64_t at = static_cast<int64_t>(k) * m + lane;
    const uint32_t word = lane <= k && at < nw ? __ldg(live_k + at) : 0u;
    const int off = k * lane + 1;           // bit of child k*i + 1 from
                                            // bit 32km of the row
    const uint32_t lo = __shfl_sync(~0u, word, off >> 5);
    const uint32_t hi = __shfl_sync(~0u, word, (off >> 5) + 1);
    kids = __funnelshift_r(lo, hi, off & 31);
  }
  if (i >= n) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const uint32_t* row = payload + base;
  uint32_t v = 0u;
  if (i > 0) v = __ldg(row + (i - 1) / k) & (0u - (parent >> lane & 1u));
  const int64_t c0 = static_cast<int64_t>(k) * i + 1;
#pragma unroll
  for (int j = 0; j < k; ++j) {             // unrolled when K > 0
    const int64_t c = c0 + j;
    if (c >= n) break;
    const uint32_t bit = k <= 31 ? kids >> j & 1u
                                 : __ldg(live_k + (c >> 5)) >> (c & 31) & 1u;
    v |= __ldg(row + c) & (0u - bit);
  }
  inbox[base + i] = v;
}

// The ring mode's table: entry e reads ring slot slot[e] (its (W, N)
// block starts at word off[e]) as a from-parent term (kind 0) or a
// from-kids term (kind 1), gated by packed liveness row row[e] of `live`
// (-1: ungated).  At most kMaxEntries entries a launch; the wrapper splits
// a longer table and ORs the inboxes.
constexpr int kMaxEntries = 16;

struct RingTable {
  int64_t off[kMaxEntries];
  int32_t kind[kMaxEntries];
  int32_t row[kMaxEntries];
  int32_t n;
};

// A child's word under its bit: bit j of `bits` spread to a mask.
__device__ __forceinline__ uint32_t gated(uint32_t word, uint32_t bits,
                                         int j) {
  return word & (0u - (bits >> j & 1u));
}

// The ring inbox for k = 4, four nodes a thread: thread q of a row ORs,
// over the table, quads_inbox's terms of each entry's slot under the
// entry's row, and writes inbox words 4q .. 4q+3 as one 16-byte store.
// A from-parent entry reads parent words q - 1 (node 4q) and q under the
// receivers' bits 4q .. 4q+3 (four bits of row word q / 8); a from-kids
// entry reads child words 16q+1 .. 16q+16 (the aligned vectors at 16q,
// 16q+4, 16q+8 and 16q+12 and the word 16q+16) under the children's bits
// 16q+1 .. 16q+16, which start at bit 16 (q % 2) + 1 of row word q / 2
// and come out of words q / 2 and q / 2 + 1 by one funnel shift (a warp
// reads 17 consecutive row words).  n % 4 == 0 and a 16-byte aligned ring
// and inbox (the entry point's condition), so every (slot, row) of the
// ring starts on the 16-byte grid and a vector lies wholly inside or
// wholly past its row.
__device__ __forceinline__ void ring_quads(const uint32_t* __restrict__ ring,
                                           const uint32_t* __restrict__ live,
                                           uint32_t* __restrict__ inbox,
                                           int64_t n, const RingTable& tab) {
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n >> 2) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const int64_t nw = (n + 31) >> 5;
  const int64_t c = 16 * q;                 // the first child word, less 1
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint32_t o0 = 0u, o1 = 0u, o2 = 0u, o3 = 0u;
  for (int e = 0; e < tab.n; ++e) {
    const uint32_t* row = ring + tab.off[e] + base;
    const int r = tab.row[e];
    const uint32_t* lrow = live + static_cast<int64_t>(r < 0 ? 0 : r) * nw;
    if (tab.kind[e] == 0) {
      const uint32_t bits =
          r < 0 ? 0xFu : __ldg(lrow + (q >> 3)) >> (4 * (q & 7)) & 0xFu;
      const uint32_t up = __ldg(row + q);
      const uint32_t up0 = q > 0 ? __ldg(row + q - 1) : 0u;
      o0 |= gated(up0, bits, 0);
      o1 |= gated(up, bits, 1);
      o2 |= gated(up, bits, 2);
      o3 |= gated(up, bits, 3);
      continue;
    }
    if (c + 1 >= n) continue;               // no child below n
    uint32_t bits = 0xFFFFu;
    if (r >= 0) {
      const int64_t m = q >> 1;
      const uint32_t lo = __ldg(lrow + m);
      const uint32_t hi = m + 1 < nw ? __ldg(lrow + m + 1) : 0u;
      bits = __funnelshift_r(lo, hi, 16 * static_cast<int>(q & 1) + 1);
    }
    const uint4* vrow = reinterpret_cast<const uint4*>(row);
    const uint4 v0 = __ldg(vrow + 4 * q);   // c < n
    const uint4 v1 = c + 4 < n ? __ldg(vrow + 4 * q + 1) : zero;
    const uint4 v2 = c + 8 < n ? __ldg(vrow + 4 * q + 2) : zero;
    const uint4 v3 = c + 12 < n ? __ldg(vrow + 4 * q + 3) : zero;
    const uint32_t last = c + 16 < n ? __ldg(row + c + 16) : 0u;
    o0 |= gated(v0.y, bits, 0) | gated(v0.z, bits, 1) | gated(v0.w, bits, 2)
          | gated(v1.x, bits, 3);
    o1 |= gated(v1.y, bits, 4) | gated(v1.z, bits, 5) | gated(v1.w, bits, 6)
          | gated(v2.x, bits, 7);
    o2 |= gated(v2.y, bits, 8) | gated(v2.z, bits, 9)
          | gated(v2.w, bits, 10) | gated(v3.x, bits, 11);
    o3 |= gated(v3.y, bits, 12) | gated(v3.z, bits, 13)
          | gated(v3.w, bits, 14) | gated(last, bits, 15);
  }
  reinterpret_cast<uint4*>(inbox + base)[q] = make_uint4(o0, o1, o2, o3);
}

// The ring inbox: tree_masked_exchange_kernel's terms, each from its own
// ring slot and under its own (or no) liveness row, ORed over the table,
// a thread a node; or (kQuads, K = 4) ring_quads, a thread four.  In the
// first form the entries are uniform across the block, so every lane of
// a warp takes part in each entry's shuffles, also past n.
template <int K, bool kQuads>
__global__ void tree_ring_exchange_kernel(const uint32_t* __restrict__ ring,
                                          const uint32_t* __restrict__ live,
                                          uint32_t* __restrict__ inbox,
                                          int64_t n, int k_arg,
                                          const RingTable tab) {
  if (kQuads) {
    ring_quads(ring, live, inbox, n, tab);
    return;
  }
  const int k = K > 0 ? K : k_arg;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t m = i >> 5;                 // the same for the whole warp
  const int64_t nw = (n + 31) >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const bool in = i < n;
  uint32_t v = 0u;
  for (int e = 0; e < tab.n; ++e) {
    const uint32_t* row = ring + tab.off[e] + base;
    const int r = tab.row[e];
    const uint32_t* lrow = live + static_cast<int64_t>(r < 0 ? 0 : r) * nw;
    if (tab.kind[e] == 0) {
      uint32_t keep = ~0u;
      if (r >= 0) {
        const uint32_t word = m < nw ? __ldg(lrow + m) : 0u;
        keep = 0u - (word >> lane & 1u);
      }
      if (in && i > 0) v |= __ldg(row + (i - 1) / k) & keep;
      continue;
    }
    uint32_t kids = ~0u;
    if (r >= 0 && k <= 31) {
      const int64_t at = static_cast<int64_t>(k) * m + lane;
      const uint32_t word = lane <= k && at < nw ? __ldg(lrow + at) : 0u;
      const int off = k * lane + 1;
      const uint32_t lo = __shfl_sync(~0u, word, off >> 5);
      const uint32_t hi = __shfl_sync(~0u, word, (off >> 5) + 1);
      kids = __funnelshift_r(lo, hi, off & 31);
    }
    if (!in) continue;
    const int64_t c0 = static_cast<int64_t>(k) * i + 1;
#pragma unroll
    for (int j = 0; j < k; ++j) {           // unrolled when K > 0
      const int64_t c = c0 + j;
      if (c >= n) break;
      const uint32_t bit =
          r < 0 ? 1u
          : k <= 31 ? kids >> j & 1u
                    : __ldg(lrow + (c >> 5)) >> (c & 31) & 1u;
      v |= __ldg(row + c) & (0u - bit);
    }
  }
  if (in) inbox[base + i] = v;
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

// Bit i of a packed row (live null: every bit set).
__device__ __forceinline__ uint32_t live_bit(const uint32_t* __restrict__ live,
                                             int64_t i) {
  return live == nullptr ? 1u : __ldg(live + (i >> 5)) >> (i & 31) & 1u;
}

// out (w, sub + 1): column 0 the block's column 0, column j >= 1 the OR
// of columns k(j-1)+1 .. kj below b, each gated by its live bit.
__global__ void tree_halo_pack_kernel(const uint32_t* __restrict__ payload,
                                      const uint32_t* __restrict__ live,
                                      uint32_t* __restrict__ out, int64_t b,
                                      int64_t sub, int k) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j > sub) return;
  const uint32_t* row = payload + static_cast<int64_t>(blockIdx.y) * b;
  uint32_t v = 0u;
  if (j == 0) {
    v = __ldg(row) & (0u - live_bit(live, 0));
  } else {
    const int64_t c0 = static_cast<int64_t>(k) * (j - 1) + 1;
    for (int t = 0; t < k; ++t) {
      const int64_t c = c0 + t;
      if (c >= b) break;
      v |= __ldg(row + c) & (0u - live_bit(live, c));
    }
  }
  out[static_cast<int64_t>(blockIdx.y) * (sub + 1) + j] = v;
}

// The inbox of column c of row blockIdx.y; with `received` the fused
// flood round (out is then the next frontier).
__global__ void tree_halo_round_kernel(const uint32_t* __restrict__ buf,
                                       const uint32_t* __restrict__ ek,
                                       const uint32_t* __restrict__ back,
                                       const uint32_t* __restrict__ live,
                                       uint32_t* __restrict__ out,
                                       uint32_t* __restrict__ received,
                                       int64_t b, int64_t sub, int k) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= b) return;
  const int64_t r = blockIdx.y;
  uint32_t v = __ldg(buf + r * (sub + 1) + (c + k - 1) / k)
               & (0u - live_bit(live, c));
  v |= __ldg(ek + r * (b + 1) + c + 1);
  if (back != nullptr && c == b - 1) v |= __ldg(back + r);
  const int64_t at = r * b + c;
  if (received == nullptr) {
    out[at] = v;
    return;
  }
  const uint32_t rec = received[at];
  const uint32_t fresh = v & ~rec;
  received[at] = rec | fresh;
  out[at] = fresh;
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

// The scalar kernel for any k, view and n; four nodes a thread for k = 4
// where n % 4 == 0 and both buffers are 16-byte aligned.
extern "C" int gg_tree_exchange(const void* payload, void* inbox, int64_t w,
                                int64_t n, int k, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(payload);
  auto* o = static_cast<uint32_t*>(inbox);
  if (k != 4 || n % 4 != 0 || (reinterpret_cast<uintptr_t>(p) & 15) != 0
      || (reinterpret_cast<uintptr_t>(o) & 15) != 0) {
    tree_exchange_kernel<false><<<node_grid(n, w), kThreads, 0, s>>>(p, o, n,
                                                                     k);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>((n / 4 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(w));
  tree_exchange_kernel<true><<<grid, kThreads, 0, s>>>(p, o, n, k);
  return static_cast<int>(cudaGetLastError());
}

// live_p and live_k: (ceil(n / 32),) packed rows.
extern "C" int gg_tree_masked_exchange(const void* payload, const void* live_p,
                                       const void* live_k, void* inbox,
                                       int64_t w, int64_t n, int k,
                                       void* stream) {
  const auto kernel = k == 4 ? &tree_masked_exchange_kernel<4>
                             : &tree_masked_exchange_kernel<0>;
  kernel<<<node_grid(n, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload),
      static_cast<const uint32_t*>(live_p),
      static_cast<const uint32_t*>(live_k), static_cast<uint32_t*>(inbox), n,
      k);
  return static_cast<int>(cudaGetLastError());
}

// ring: (slots, w, n); table: n_entries triples (slot, kind, row) as
// int64 host words (RingTable); live: (rows, ceil(n / 32)) packed rows, or
// null when no entry has a row.
extern "C" int gg_tree_ring_exchange(const void* ring, const void* live,
                                     void* inbox, int64_t slots, int64_t w,
                                     int64_t n, int k, const int64_t* table,
                                     int n_entries, void* stream) {
  if (n_entries < 0 || n_entries > kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  RingTable tab{};
  tab.n = n_entries;
  for (int e = 0; e < n_entries; ++e) {
    const int64_t slot = table[3 * e], kind = table[3 * e + 1],
                  row = table[3 * e + 2];
    if (slot < 0 || slot >= slots || (kind != 0 && kind != 1)
        || (row >= 0 && live == nullptr) || row < -1)
      return static_cast<int>(cudaErrorInvalidValue);
    tab.off[e] = slot * w * n;
    tab.kind[e] = static_cast<int32_t>(kind);
    tab.row[e] = static_cast<int32_t>(row);
  }
  const auto* r = static_cast<const uint32_t*>(ring);
  const auto* lv = static_cast<const uint32_t*>(live);
  auto* o = static_cast<uint32_t*>(inbox);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k == 4 && n % 4 == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0
      && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const dim3 grid(static_cast<unsigned>((n / 4 + kThreads - 1) / kThreads),
                    static_cast<unsigned>(w));
    tree_ring_exchange_kernel<4, true><<<grid, kThreads, 0, s>>>(r, lv, o, n,
                                                                 k, tab);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = k == 4 ? &tree_ring_exchange_kernel<4, false>
                             : &tree_ring_exchange_kernel<0, false>;
  kernel<<<node_grid(n, w), kThreads, 0, s>>>(r, lv, o, n, k, tab);
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

// payload (w, b), live (ceil(b / 32)) packed or null, out (w, b / k + 1);
// k | b, b >= k.
extern "C" int gg_tree_halo_pack(const void* payload, const void* live,
                                 void* out, int64_t w, int64_t b, int k,
                                 void* stream) {
  if (k < 1 || b < k || b % k != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t sub = b / k;
  tree_halo_pack_kernel<<<node_grid(sub + 1, w), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload),
      static_cast<const uint32_t*>(live), static_cast<uint32_t*>(out), b, sub,
      k);
  return static_cast<int>(cudaGetLastError());
}

// buf (w, b / k + 1), ek (w, b + 1), back (w) or null, live (ceil(b / 32))
// or null, out (w, b); received (w, b) or null (the fused round).
extern "C" int gg_tree_halo_round(const void* buf, const void* ek,
                                  const void* back, const void* live,
                                  void* out, void* received, int64_t w,
                                  int64_t b, int k, void* stream) {
  if (k < 1 || b < k || b % k != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tree_halo_round_kernel<<<node_grid(b, w), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), static_cast<const uint32_t*>(ek),
      static_cast<const uint32_t*>(back), static_cast<const uint32_t*>(live),
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(received), b,
      b / k, k);
  return static_cast<int>(cudaGetLastError());
}
