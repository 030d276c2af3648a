// Hand-written Hopper (sm_90a) kernels of the replicated log's round
// (Gossip Glomers challenge 5, "Kafka"): four passes over the (N, K, Wc)
// presence words and the (N, K) committed-offset cache, both updated in
// place, and no host sync.
//
// Layout: present[n, k, w] at (n * K + k) * Wc + w, bit c % 32 of word
// c // 32 set iff node n holds slot c of key k; lc[n, k] at n * K + k.
// top_off(word w) = 32 w + 32 - clz(word) (0 for a zero word), the offset
// of the word's highest bit; a (n, k)'s top_off is the max over its words.
//
// - kafka_merge: the merge pass.  Per (n, k): a row with wipe[n] loses
//   its presence and cache (amnesia); d = row[k] | carry[n, k] | own[n,
//   k] (whichever are given: the union row every node receives, a row's
//   own faulted delivery, the matmul path's own appends); present |= d;
//   lc = max(lc, top_off(d)).  On a resync round it also ORs, over the
//   live rows, the presence after delivery (pull) or the origin bits
//   (push) into the (K, Wc) union, and flags each row that holds any
//   origin bit (push).  A word whose d is 0 reads no presence unless the
//   row is wiped or the pass pulls, so a key that received no bit this
//   round costs only its delivery words.
//   Replaces: gossip_glomers_tpu/tpu_sim/kafka.py _round :438-442 (the
//   wipe), :516 / :544 / :598 / :633 (present | deliver), :641-659 (the
//   HWM) and :695-710 (the resync unions), XLA code: selects, ORs, a
//   count-leading-zeros max and a masked OR reduce over the node axis.
// - kafka_nem_deliver: the faulted origin union of the destination rows
//   [lo, hi) (:517-598).  Block b owns row dst = lo + b: it zeroes the
//   row, then walks the round's N S sends; a send m from origin m / S
//   lands (atomicOr of its bit into its word) iff up[dst] and the loss
//   coin mix32(origin * 0xC2B2AE35 ^ dst * 0x27D4EB2F ^ key) is not
//   below loss_num, or origin == dst.  key = t * 0x9E3779B9 ^ seed ^
//   0x9E3779B9 (the loss salt), the hash of faults.py edge_drop and
//   fault_flood.cu.  A down row walks only its own S sends.  No coin
//   tensor: the reference's is (rows, N S) uint32.
// - kafka_commit_select: on a round with commits or a resync.  Per (n,
//   k): a row with take[n] gains union & ~present and max-bumps lc to
//   its top_off (:711-715); then the commit classification (:746-761) of
//   req against hwm = lc and the cell after the sends, kv_sent[k]: want
//   = req >= 1 (and want_ok[n]); a dance unless 0 < hwm >= req; active
//   where reach[n], else blocked; an active dance reads only (cell
//   exists and >= req), needs the CAS (exists, < req) or writes (the
//   cell is missing).  Per key, the lowest CAS row and the highest
//   writer row (:763-766); four counts: active, blocked, write legs
//   (CAS or write) and the tally rows (resync takes or pushers).
// - kafka_commit_apply: per (n, k), lc = max(lc, learn), learn = req for
//   the key's CAS winner and for writers, kv_sent for read-only dances,
//   else 0 (:776-780); per key the new cell, the CAS winner's request,
//   else the last writer's, else kv_sent (:767-774); and msgs + 2 active
//   + kv_retries blocked + 2 write legs + tally_mult tally, mod 2^32
//   (:793-818).
//
// Block forms (a mesh rank's N rows of the sim's, in place of the whole
// axis): kafka_nem_deliver's rows are global rows row0 + dst and its
// sends come from any M origins origin0 + m / S (all N of the sim, or one
// rank's block visiting on the ring), ORed into the rows when accumulating;
// kafka_commit_select's CAS and writer rows are global (row0 + node) and
// its sentinel, set by the caller, is the sim's N + 1, so the blocks'
// results reduce by a minimum and a maximum; kafka_commit_apply learns by
// global row and, in its partial form, writes the winner's and the last
// writer's requests where those rows lie in the block (0 elsewhere) for
// the caller to sum over the blocks.  kafka_merge needs none: its wipe
// rows are the caller's, its resync union the block's partial.
//
// The fault-free round's merge (the union row alone, Wc of 1, 2 or 4) is
// kafka_merge_kernel's row mode: the key's delivery words and their top
// stay in registers, and each thread has the loads of four nodes in
// flight.
// kafka_nem_deliver builds its row in shared memory (atomics there, one
// coalesced write) where K Wc words fit in 227 KB, a block of 1,024
// threads a row; a wider row takes the global atomics.
//
// Bound on the card.  All four are bytes-bound.  kafka_merge reads and
// writes the presence of every key that received a bit (and the cache
// where the top rose), reads its delivery words, and on a resync round
// reads every live row's presence or origin bits; at config5b's
// 1,024-node row (10,000 keys, C = 128) the whole presence is 164 MB each
// way, 0.122 ms at 3.35 TB/s for read + write; at 131,072 nodes (8,192
// keys, C = 64) 8.6 GB and 4.3 GB of cache.  kafka_nem_deliver writes its
// rows (K Wc words each) and does 16 integer operations a send a row
// (the hash and its compare).  The commit passes read the cache and the
// requests (and the presence on a take), 8 bytes a (n, k) each.  Design:
// the three (n, k) passes share one tiling, a block of 256 threads = tk
// keys (32..256, consecutive threads on consecutive keys, so a warp reads
// 32 neighbouring rows' words) x 256 / tk node lanes, each block a
// chunk of nodes sized so the grid has some 8 blocks an SM; words move
// 16 or 8 bytes a load where Wc and every pointer allow.  The per-key
// reductions over the node axis (the union ORs, the CAS minimum, the
// writer maximum) reduce within the block first, in shared memory, then
// add one atomic a key (and word) a block; the row flags one atomic a
// warp; the counts one atomic a block.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxWords = 48;        // kernels.KAFKA_MAX_WORDS
constexpr int kCounts = 4;           // kernels.KAFKA_COUNTS
constexpr int kPull = 1, kPush = 2;  // kernels.RESYNC_*
// kafka_nem_deliver: threads a block (one destination row), and the most
// shared memory a block may stage its row in (the card's 227 KB)
constexpr int kNemThreads = 1024;
constexpr int kNemSmemBytes = 227 * 1024;

template <int V>
struct Words {
  uint32_t v[V];
};

template <int V>
__device__ __forceinline__ Words<V> zero_words() {
  Words<V> w;
#pragma unroll
  for (int j = 0; j < V; ++j) w.v[j] = 0;
  return w;
}

template <int V>
__device__ __forceinline__ Words<V> load(const uint32_t* p) {
  Words<V> w;
  if constexpr (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w.v[0] = x.x, w.v[1] = x.y, w.v[2] = x.z, w.v[3] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w.v[0] = x.x, w.v[1] = x.y;
  } else {
    w.v[0] = *p;
  }
  return w;
}

template <int V>
__device__ __forceinline__ void store(uint32_t* p, const Words<V>& w) {
  if constexpr (V == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(w.v[0], w.v[1]);
  else
    *p = w.v[0];
}

template <int V>
__device__ __forceinline__ bool any_bit(const Words<V>& w) {
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) x |= w.v[j];
  return x != 0;
}

// max(top, top_off of the V words starting at word w)
template <int V>
__device__ __forceinline__ int32_t top_of(const Words<V>& x, int w,
                                          int32_t top) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (x.v[j])
      top = max(top, (w + j) * 32 + 32 - __clz(static_cast<int>(x.v[j])));
  return top;
}

__device__ __forceinline__ bool aligned_dev(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The (n, k) passes' tiling: a block is tk keys x (kThreads / tk) node
// lanes over the nodes [blockIdx.y * nb, + nb).
struct Tile {
  int tk;
  int64_t nb;
};

struct TileIdx {
  int tx, ty, lanes;
  int64_t key, n0, n1;
};

__device__ __forceinline__ TileIdx tile_idx(const Tile& t, int64_t n) {
  TileIdx i;
  i.tx = threadIdx.x % t.tk;
  i.ty = threadIdx.x / t.tk;
  i.lanes = kThreads / t.tk;
  i.key = static_cast<int64_t>(blockIdx.x) * t.tk + i.tx;
  i.n0 = static_cast<int64_t>(blockIdx.y) * t.nb;
  i.n1 = i.n0 + t.nb < n ? i.n0 + t.nb : n;
  return i;
}

struct Merge {
  uint32_t* present;
  int32_t* lc;
  const uint8_t* wipe;     // (n,) or null
  const uint32_t* row;     // (k, wc) or null
  const uint32_t* carry;   // (n, k, wc) or null
  const uint32_t* own;     // (n, k, wc) or null
  const uint8_t* live;     // (n,), a resync round's
  const uint32_t* origin;  // (n, k, wc), push
  uint32_t* union_out;     // (k, wc), zeroed, a resync round's
  int32_t* any_out;        // (n,), zeroed, push
  int64_t n, k;
  int wc, resync;
  Tile tile;
};

// every mode, V words a load
template <int V>
__device__ __forceinline__ void merge_any(const Merge& m) {
  extern __shared__ uint32_t uni_s[];          // tk x wc, a resync round's
  const TileIdx ti = tile_idx(m.tile, m.n);
  const int64_t wc = m.wc;
  if (m.resync) {
    for (int i = threadIdx.x; i < m.tile.tk * m.wc; i += kThreads)
      uni_s[i] = 0;
    __syncthreads();
  }
  const bool kin = ti.key < m.k;
  uint32_t* mine = uni_s + ti.tx * m.wc;
  for (int64_t node = ti.n0 + ti.ty; node < ti.n1; node += ti.lanes) {
    bool any = false;
    if (kin) {
      const int64_t nk = node * m.k + ti.key;
      const bool wiped = m.wipe && m.wipe[node];
      const bool live = m.resync && m.live[node];
      const bool pull = m.resync == kPull && live;
      uint32_t* p = m.present + nk * wc;
      int32_t top = 0;
      for (int w = 0; w < m.wc; w += V) {
        Words<V> d = zero_words<V>();
        if (m.row) {
          const Words<V> x = load<V>(m.row + ti.key * wc + w);
#pragma unroll
          for (int j = 0; j < V; ++j) d.v[j] |= x.v[j];
        }
        if (m.carry) {
          const Words<V> x = load<V>(m.carry + nk * wc + w);
#pragma unroll
          for (int j = 0; j < V; ++j) d.v[j] |= x.v[j];
        }
        if (m.own) {
          const Words<V> x = load<V>(m.own + nk * wc + w);
#pragma unroll
          for (int j = 0; j < V; ++j) d.v[j] |= x.v[j];
        }
        const bool delivered = any_bit<V>(d);
        if (wiped || delivered || pull) {
          Words<V> pv = wiped ? zero_words<V>() : load<V>(p + w);
          if (delivered) {
#pragma unroll
            for (int j = 0; j < V; ++j) pv.v[j] |= d.v[j];
            top = top_of<V>(d, w, top);
          }
          if (wiped || delivered) store<V>(p + w, pv);
          if (pull) {
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (pv.v[j]) atomicOr(mine + w + j, pv.v[j]);
          }
        }
        if (m.resync == kPush) {
          const Words<V> o = load<V>(m.origin + nk * wc + w);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (o.v[j]) {
              any = true;
              if (live) atomicOr(mine + w + j, o.v[j]);
            }
          }
        }
      }
      if (wiped)
        m.lc[nk] = top;
      else if (top > 0 && top > m.lc[nk])
        m.lc[nk] = top;
    }
    // a warp's lanes share their node: one flag atomic a warp
    if (m.resync == kPush && __any_sync(0xFFFFFFFFu, any)
        && threadIdx.x % 32 == 0)
      atomicOr(m.any_out + node, 1);
  }
  if (m.resync) {
    __syncthreads();
    for (int i = threadIdx.x; i < m.tile.tk * m.wc; i += kThreads) {
      const int64_t key = static_cast<int64_t>(blockIdx.x) * m.tile.tk
                          + i / m.wc;
      if (key < m.k && uni_s[i])
        atomicOr(m.union_out + key * wc + i % m.wc, uni_s[i]);
    }
  }
}

// The union-row merge alone (the fault-free round: no wipe, no carry, no
// resync), WC words a key: the key's delivery words and their top sit in
// registers, and a thread issues the loads of kUnroll of its nodes
// before their stores.
constexpr int kUnroll = 4;

template <int WC>
__device__ __forceinline__ void merge_row(const Merge& m) {
  const TileIdx ti = tile_idx(m.tile, m.n);
  if (ti.key >= m.k) return;
  const Words<WC> d = load<WC>(m.row + ti.key * WC);
  if (!any_bit<WC>(d)) return;                 // no bit for this key
  const int32_t top = top_of<WC>(d, 0, 0);
  uint32_t* __restrict__ present = m.present;
  int32_t* __restrict__ lc = m.lc;
  const int64_t lanes = ti.lanes;
  for (int64_t base = ti.n0 + ti.ty; base < ti.n1; base += lanes * kUnroll) {
    Words<WC> p[kUnroll];
    int32_t l[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t nk = (base + u * lanes) * m.k + ti.key;
      if (base + u * lanes < ti.n1) {
        p[u] = load<WC>(present + nk * WC);
        l[u] = lc[nk];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t nk = (base + u * lanes) * m.k + ti.key;
      if (base + u * lanes < ti.n1) {
#pragma unroll
        for (int j = 0; j < WC; ++j) p[u].v[j] |= d.v[j];
        store<WC>(present + nk * WC, p[u]);
        if (top > l[u]) lc[nk] = top;
      }
    }
  }
}

// kRow: the union row alone (merge_row, V = Wc); else merge_any
template <int V, bool kRow>
__global__ void __launch_bounds__(kThreads)
    kafka_merge_kernel(const Merge m) {
  if constexpr (kRow)
    merge_row<V>(m);
  else
    merge_any<V>(m);
}

struct Nem {
  uint32_t* deliver;       // (n, k, wc): the destination rows
  const int32_t* widx;     // (m s,): key * wc + word, -1 for none
  const uint32_t* bit;     // (m s,): 0 for none
  const uint8_t* up;       // (n,), by destination row
  int64_t m, kw, s, lo;
  int64_t row0, origin0;   // global ids of row 0 and of origin 0
  uint32_t key, loss_num;
  bool accumulate;         // OR into the rows instead of overwriting
};

// A block's fill of kw words: zeros (src null) or a copy of src.
__device__ __forceinline__ void fill_row(uint32_t* dst, const uint32_t* src,
                                         int64_t kw, bool vec) {
  if (vec) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int64_t i = threadIdx.x; i < kw / 4; i += blockDim.x)
      d4[i] = src ? s4[i] : make_uint4(0, 0, 0, 0);
  } else {
    for (int64_t i = threadIdx.x; i < kw; i += blockDim.x)
      dst[i] = src ? src[i] : 0u;
  }
}

// kStaged: the row is built in shared memory (kw words) and written out
// once; else its atomics go to the row in global memory
template <bool kStaged>
__global__ void __launch_bounds__(kNemThreads)
    kafka_nem_deliver_kernel(const Nem a) {
  extern __shared__ uint4 staged_s[];
  const int64_t local = a.lo + blockIdx.x;
  const int64_t dst = a.row0 + local;           // the global row id
  uint32_t* out = a.deliver + local * a.kw;
  uint32_t* row = kStaged ? reinterpret_cast<uint32_t*>(staged_s) : out;
  const bool out_vec = aligned_dev(out, 16) && a.kw % 4 == 0;
  // the row starts empty, or (accumulating) from what it holds: staged,
  // a copy of it; in global memory, as it is
  if (kStaged || !a.accumulate)
    fill_row(row, a.accumulate ? out : nullptr, a.kw,
             kStaged ? a.kw % 4 == 0 && (!a.accumulate || out_vec)
                     : out_vec);
  __syncthreads();
  const bool up = a.up[local];
  // a down row receives nothing but keeps its own appends, where its
  // own sends are among the m origins
  const int64_t own = dst - a.origin0;
  const bool own_in = own >= 0 && own < a.m;
  const int64_t m0 = up ? 0 : own_in ? own * a.s : 0;
  const int64_t m1 = up ? a.m * a.s : own_in ? m0 + a.s : 0;
  const uint32_t dst_term = static_cast<uint32_t>(dst) * 0x27D4EB2Fu ^ a.key;
  for (int64_t m = m0 + threadIdx.x; m < m1; m += blockDim.x) {
    const uint32_t b = a.bit[m];
    if (!b) continue;
    const int64_t origin = a.origin0 + m / a.s;
    if (origin != dst
        && mix32(static_cast<uint32_t>(origin) * 0xC2B2AE35u ^ dst_term)
               < a.loss_num)
      continue;
    atomicOr(row + a.widx[m], b);
  }
  if (kStaged) {
    __syncthreads();
    fill_row(out, row, a.kw, out_vec);
  }
}

struct Select {
  uint32_t* present;
  int32_t* lc;
  const uint8_t* take;     // (n,) or null: no resync take
  const uint32_t* uni;     // (k, wc), with take
  const int32_t* req;      // (n, k) or null: no commits
  const uint8_t* want_ok;  // (n,) or null: every node is up
  const uint8_t* reach;    // (n,), with req
  const int32_t* kv_sent;  // (k,), with req
  const uint8_t* tally;    // (n,) or null
  int32_t* cas_win;        // (k,), the sim's N + 1 at rest
  int32_t* wrt_last;       // (k,), -1 at rest
  unsigned long long* counts;  // kCounts, zeroed
  int64_t n, k;
  int64_t row0;            // the global id of row 0 (a mesh rank's block)
  int wc;
  Tile tile;
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    kafka_commit_select_kernel(const Select s) {
  __shared__ int32_t cas_s[kThreads], wrt_s[kThreads];
  __shared__ unsigned long long cnt_s[kWarps][kCounts];
  const TileIdx ti = tile_idx(s.tile, s.n);
  const int64_t wc = s.wc;
  const bool kin = ti.key < s.k;
  const int32_t sent = kin && s.req ? s.kv_sent[ti.key] : 0;
  int32_t cas = INT_MAX, wrt = -1;
  unsigned long long cnt[kCounts] = {0, 0, 0, 0};
  for (int64_t node = ti.n0 + ti.ty; kin && node < ti.n1;
       node += ti.lanes) {
    const int64_t nk = node * s.k + ti.key;
    int32_t hwm = s.lc[nk];
    if (s.take && s.take[node]) {
      uint32_t* p = s.present + nk * wc;
      int32_t top = 0;
      for (int w = 0; w < s.wc; w += V) {
        const Words<V> u = load<V>(s.uni + ti.key * wc + w);
        if (!any_bit<V>(u)) continue;
        Words<V> pv = load<V>(p + w), gain;
#pragma unroll
        for (int j = 0; j < V; ++j) gain.v[j] = u.v[j] & ~pv.v[j];
        if (!any_bit<V>(gain)) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) pv.v[j] |= gain.v[j];
        store<V>(p + w, pv);
        top = top_of<V>(gain, w, top);
      }
      if (top > hwm) {
        hwm = top;
        s.lc[nk] = hwm;
      }
    }
    if (s.tally && ti.key == 0 && s.tally[node]) ++cnt[3];
    if (s.req) {
      const int32_t r = s.req[nk];
      const bool want = r >= 1 && (!s.want_ok || s.want_ok[node]);
      if (want && !(hwm > 0 && hwm >= r)) {
        if (s.reach[node]) {
          ++cnt[0];
          if (sent > 0) {
            if (r > sent) {
              ++cnt[2];
              cas = min(cas, static_cast<int32_t>(s.row0 + node));
            }
          } else {
            ++cnt[2];
            wrt = max(wrt, static_cast<int32_t>(s.row0 + node));
          }
        } else {
          ++cnt[1];
        }
      }
    }
  }
  cas_s[threadIdx.x] = cas;
  wrt_s[threadIdx.x] = wrt;
#pragma unroll
  for (int c = 0; c < kCounts; ++c)
    for (int o = 16; o > 0; o >>= 1)
      cnt[c] += __shfl_xor_sync(0xFFFFFFFFu, cnt[c], o);
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int c = 0; c < kCounts; ++c) cnt_s[threadIdx.x / 32][c] = cnt[c];
  }
  __syncthreads();
  if (ti.ty == 0 && kin && s.req) {
    for (int l = 1; l < ti.lanes; ++l) {
      cas = min(cas, cas_s[l * s.tile.tk + ti.tx]);
      wrt = max(wrt, wrt_s[l * s.tile.tk + ti.tx]);
    }
    if (cas != INT_MAX) atomicMin(s.cas_win + ti.key, cas);
    if (wrt >= 0) atomicMax(s.wrt_last + ti.key, wrt);
  }
  if (threadIdx.x == 0) {
    for (int c = 0; c < kCounts; ++c) {
      unsigned long long total = 0;
      for (int w = 0; w < kWarps; ++w) total += cnt_s[w][c];
      if (total) atomicAdd(s.counts + c, total);
    }
  }
}

struct Apply {
  int32_t* lc;
  const int32_t* req;
  const int32_t* cas_win;
  const int32_t* wrt_last;
  const int32_t* kv_sent;
  const uint8_t* reach;
  const uint8_t* want_ok;  // or null
  const unsigned long long* counts;
  const long long* msgs;    // null in the partial form
  int32_t* kv_out;          // (k,), or (2, k) in the partial form
  long long* msgs_out;      // null in the partial form
  int64_t n, k;
  int64_t row0, nt;         // the global id of row 0; the sim's N
  bool partial;
  unsigned long long kv_retries, tally_mult;
  Tile tile;
};

__global__ void __launch_bounds__(kThreads)
    kafka_commit_apply_kernel(const Apply a) {
  const TileIdx ti = tile_idx(a.tile, a.n);
  if (a.msgs && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    const unsigned long long* c = a.counts;
    *a.msgs_out = static_cast<long long>(
        (static_cast<unsigned long long>(*a.msgs) + 2ull * c[0]
         + a.kv_retries * c[1] + 2ull * c[2] + a.tally_mult * c[3])
        & 0xFFFFFFFFull);
  }
  if (ti.key >= a.k) return;
  const int32_t sent = a.kv_sent[ti.key];
  const int32_t win = a.cas_win[ti.key];
  if (blockIdx.y == 0 && ti.ty == 0) {
    const int32_t last = a.wrt_last[ti.key];
    const int64_t wl = win - a.row0, ll = last - a.row0;
    if (a.partial) {
      // the winner's and the last writer's requests where they lie in
      // this block, 0 elsewhere: the mesh sums them over the blocks
      a.kv_out[ti.key] =
          win < a.nt && wl >= 0 && wl < a.n ? a.req[wl * a.k + ti.key] : 0;
      a.kv_out[a.k + ti.key] =
          last >= 0 && ll >= 0 && ll < a.n ? a.req[ll * a.k + ti.key] : 0;
    } else {
      a.kv_out[ti.key] = win < a.nt ? a.req[wl * a.k + ti.key]
                         : last >= 0 ? a.req[ll * a.k + ti.key]
                                     : sent;
    }
  }
  for (int64_t node = ti.n0 + ti.ty; node < ti.n1; node += ti.lanes) {
    const int64_t nk = node * a.k + ti.key;
    const int32_t r = a.req[nk];
    if (r < 1 || (a.want_ok && !a.want_ok[node]) || !a.reach[node])
      continue;
    const int32_t hwm = a.lc[nk];
    if (hwm > 0 && hwm >= r) continue;
    const int32_t learn =
        sent > 0 ? (r > sent ? (a.row0 + node == win ? r : 0) : sent) : r;
    if (learn > hwm) a.lc[nk] = learn;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The (n, k) tiling and its grid: tk the least power of two >= k in
// [32, 256]; node chunks so that the grid has some kBlocksPerSm blocks an
// SM (at least a node lane's worth of nodes a chunk, at most 65535
// chunks).
Tile make_tile(int64_t n, int64_t k, dim3* grid) {
  Tile t;
  t.tk = 32;
  while (t.tk < kThreads && t.tk < k) t.tk *= 2;
  const int64_t lanes = kThreads / t.tk;
  const int64_t key_tiles = (k + t.tk - 1) / t.tk;
  const int64_t want = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  int64_t chunks = (want + key_tiles - 1) / key_tiles;
  chunks = std::min(chunks, (n + lanes - 1) / lanes);
  chunks = std::max<int64_t>(1, std::min<int64_t>(chunks, 65535));
  t.nb = (n + chunks - 1) / chunks;
  chunks = (n + t.nb - 1) / t.nb;
  *grid = dim3(static_cast<unsigned>(key_tiles),
               static_cast<unsigned>(chunks));
  return t;
}

// words a load: 4 or 2 where wc and every given word pointer allow
int vec_width(int wc, const void* const* ptrs, int count) {
  for (const int v : {4, 2}) {
    if (wc % v) continue;
    bool ok = true;
    for (int i = 0; i < count; ++i)
      ok = ok && (ptrs[i] == nullptr || aligned(ptrs[i], 4 * v));
    if (ok) return v;
  }
  return 1;
}

bool bad_shape(int64_t n, int64_t k, int64_t wc) {
  return n < 1 || n >= (int64_t{1} << 31) - 1 || k < 1
         || k >= (int64_t{1} << 31) || wc < 1 || wc > kMaxWords;
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an argument it cannot take).  The caller
// guarantees device pointers to contiguous buffers of the shapes named
// in the structs above: int32 words and caches, bool rows as bytes, the
// zeroed union (k, wc) and flags (n,) of a resync pass, cas_win / wrt_last
// at n + 1 / -1 and the counts zeroed before each select pass.

extern "C" int gg_kafka_merge(void* present, void* lc, const void* wipe,
                              const void* row, const void* carry,
                              const void* own, const void* live,
                              const void* origin, void* union_out,
                              void* any_out, int64_t n, int64_t k,
                              int64_t wc, int resync, void* stream) {
  if (bad_shape(n, k, wc) || resync < 0 || resync > kPush
      || (resync && (live == nullptr || union_out == nullptr))
      || (resync == kPush && (origin == nullptr || any_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Merge m;
  m.present = static_cast<uint32_t*>(present);
  m.lc = static_cast<int32_t*>(lc);
  m.wipe = static_cast<const uint8_t*>(wipe);
  m.row = static_cast<const uint32_t*>(row);
  m.carry = static_cast<const uint32_t*>(carry);
  m.own = static_cast<const uint32_t*>(own);
  m.live = static_cast<const uint8_t*>(live);
  m.origin = resync == kPush ? static_cast<const uint32_t*>(origin) : nullptr;
  m.union_out = static_cast<uint32_t*>(union_out);
  m.any_out = static_cast<int32_t*>(any_out);
  m.n = n;
  m.k = k;
  m.wc = static_cast<int>(wc);
  m.resync = resync;
  dim3 grid;
  m.tile = make_tile(n, k, &grid);
  const void* words[] = {present, row, carry, own, m.origin, union_out};
  const int v = vec_width(m.wc, words, 6);
  const size_t smem = resync ? sizeof(uint32_t) * m.tile.tk * m.wc : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the union row alone, at a width of one whole load
  if (row && !wipe && !carry && !own && !resync && v == m.wc) {
    if (v == 4)
      kafka_merge_kernel<4, true><<<grid, kThreads, 0, st>>>(m);
    else if (v == 2)
      kafka_merge_kernel<2, true><<<grid, kThreads, 0, st>>>(m);
    else
      kafka_merge_kernel<1, true><<<grid, kThreads, 0, st>>>(m);
  } else if (v == 4) {
    kafka_merge_kernel<4, false><<<grid, kThreads, smem, st>>>(m);
  } else if (v == 2) {
    kafka_merge_kernel<2, false><<<grid, kThreads, smem, st>>>(m);
  } else {
    kafka_merge_kernel<1, false><<<grid, kThreads, smem, st>>>(m);
  }
  return static_cast<int>(cudaGetLastError());
}

// Raises the staged kafka_nem_deliver's shared-memory limit to
// kNemSmemBytes on the current device, once a device (the attribute is
// each device's own).
static cudaError_t nem_smem_limit() {
  constexpr int kDevices = 64;
  static bool set[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kafka_nem_deliver_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kNemSmemBytes);
  if (err == cudaSuccess && dev < kDevices) set[dev] = true;
  return err;
}

extern "C" int gg_kafka_nem_deliver(void* deliver, const void* widx,
                                    const void* bit, const void* up,
                                    int64_t n, int64_t k, int64_t wc,
                                    int64_t s, int64_t m, int64_t lo,
                                    int64_t hi, int64_t row0,
                                    int64_t origin0, int accumulate,
                                    int64_t key, int64_t loss_num,
                                    void* stream) {
  if (bad_shape(n, k, wc) || s < 1 || m < 0
      || m * s >= (int64_t{1} << 31) || lo < 0 || hi > n || lo > hi
      || row0 < 0 || origin0 < 0 || row0 + n >= (int64_t{1} << 31)
      || origin0 + m >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hi == lo) return static_cast<int>(cudaGetLastError());
  Nem a;
  a.deliver = static_cast<uint32_t*>(deliver);
  a.widx = static_cast<const int32_t*>(widx);
  a.bit = static_cast<const uint32_t*>(bit);
  a.up = static_cast<const uint8_t*>(up);
  a.m = m;
  a.kw = k * wc;
  a.s = s;
  a.lo = lo;
  a.row0 = row0;
  a.origin0 = origin0;
  a.accumulate = accumulate != 0;
  a.key = static_cast<uint32_t>(key);
  a.loss_num = static_cast<uint32_t>(loss_num);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned rows = static_cast<unsigned>(hi - lo);
  const int64_t bytes = 4 * a.kw;
  if (bytes <= kNemSmemBytes) {
    const cudaError_t err = nem_smem_limit();
    if (err != cudaSuccess) return static_cast<int>(err);
    kafka_nem_deliver_kernel<true>
        <<<rows, kNemThreads, static_cast<size_t>(bytes), st>>>(a);
  } else {
    kafka_nem_deliver_kernel<false><<<rows, kNemThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_kafka_commit_select(
    void* present, void* lc, const void* take, const void* uni,
    const void* req, const void* want_ok, const void* reach,
    const void* kv_sent, const void* tally, void* cas_win, void* wrt_last,
    void* counts, int64_t n, int64_t k, int64_t wc, int64_t row0,
    void* stream) {
  if (bad_shape(n, k, wc) || (take && !uni)
      || (req && (!reach || !kv_sent)) || row0 < 0
      || row0 + n >= (int64_t{1} << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Select s;
  s.present = static_cast<uint32_t*>(present);
  s.lc = static_cast<int32_t*>(lc);
  s.take = static_cast<const uint8_t*>(take);
  s.uni = static_cast<const uint32_t*>(uni);
  s.req = static_cast<const int32_t*>(req);
  s.want_ok = static_cast<const uint8_t*>(want_ok);
  s.reach = static_cast<const uint8_t*>(reach);
  s.kv_sent = static_cast<const int32_t*>(kv_sent);
  s.tally = static_cast<const uint8_t*>(tally);
  s.cas_win = static_cast<int32_t*>(cas_win);
  s.wrt_last = static_cast<int32_t*>(wrt_last);
  s.counts = static_cast<unsigned long long*>(counts);
  s.n = n;
  s.k = k;
  s.row0 = row0;
  s.wc = static_cast<int>(wc);
  dim3 grid;
  s.tile = make_tile(n, k, &grid);
  const void* words[] = {present, take ? uni : nullptr};
  const int v = vec_width(s.wc, words, 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v == 4)
    kafka_commit_select_kernel<4><<<grid, kThreads, 0, st>>>(s);
  else if (v == 2)
    kafka_commit_select_kernel<2><<<grid, kThreads, 0, st>>>(s);
  else
    kafka_commit_select_kernel<1><<<grid, kThreads, 0, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_kafka_commit_apply(
    void* lc, const void* req, const void* cas_win, const void* wrt_last,
    const void* kv_sent, const void* reach, const void* want_ok,
    const void* counts, const void* msgs, void* kv_out, void* msgs_out,
    int64_t n, int64_t k, int64_t row0, int64_t nt, int partial,
    int64_t kv_retries, int64_t tally_mult, void* stream) {
  if (bad_shape(n, k, 1) || kv_retries < 0 || tally_mult < 0 || row0 < 0
      || row0 + n > nt || nt >= (int64_t{1} << 31) - 1
      || (!partial && (!msgs || !msgs_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  Apply a;
  a.lc = static_cast<int32_t*>(lc);
  a.req = static_cast<const int32_t*>(req);
  a.cas_win = static_cast<const int32_t*>(cas_win);
  a.wrt_last = static_cast<const int32_t*>(wrt_last);
  a.kv_sent = static_cast<const int32_t*>(kv_sent);
  a.reach = static_cast<const uint8_t*>(reach);
  a.want_ok = static_cast<const uint8_t*>(want_ok);
  a.counts = static_cast<const unsigned long long*>(counts);
  a.msgs = static_cast<const long long*>(msgs);
  a.kv_out = static_cast<int32_t*>(kv_out);
  a.msgs_out = static_cast<long long*>(msgs_out);
  a.n = n;
  a.k = k;
  a.row0 = row0;
  a.nt = nt;
  a.partial = partial != 0;
  a.kv_retries = static_cast<unsigned long long>(kv_retries);
  a.tally_mult = static_cast<unsigned long long>(tally_mult);
  dim3 grid;
  a.tile = make_tile(n, k, &grid);
  kafka_commit_apply_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
