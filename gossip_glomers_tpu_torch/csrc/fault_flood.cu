// Hand-written Hopper (sm_90a) kernels of the faulted node-major gather
// round: the Maelstrom nemesis (crash/restart, lossy links, duplicate
// delivery, membership) on the general-graph broadcast path.
//
// The adjacency is an (n, D) int32 table padded with -1 (a slab of rows of
// the whole table: row i of the slab is the node row0 + i); bitsets are
// (N, W) node-major, word c of node i at i * W + c.  One flag byte per edge
// slot carries the round's per-edge coins from the first kernel to the
// second:
//
//   SEND   = the edge is live (partition mask, else index >= 0) and both
//            endpoints are up: a send is charged;
//   DEL    = SEND and the loss coin of src -> dst did not drop it;
//   DUP    = DEL and the dup coin of src -> dst fired;
//   OUT_OK = the loss coin of dst -> src did not drop (the reply).
//
// - fault_coins:          the flag bytes of the slab's edges.
//   Replaces: gossip_glomers_tpu/tpu_sim/broadcast.py _live_split
//   (:162-182) with faults.py edge_drop / edge_dup (:529-554) and the
//   srv ledger's out_ok (broadcast.py:534-538), XLA elementwise code over
//   (N, D) masks.
// - faulted_gather_round: inbox = OR_{DEL} payload[src] | OR_{DUP}
//   received[src], new = inbox & ~rec, rec_next = rec | new (out of place),
//   and the dup charge sum_{DUP} popc(received[src]) mod 2^32.
//   Replaces: broadcast.py :475-483 (the dup ledger charge), :557-560 (the
//   two masked gathers) and :579 (the merge).
// - wm_fault_coins:       the words-major (structured) nemesis's coins over
//   D direction rows, each row's sender and receiver ids given as closed
//   forms of the receiver column i (a (D, 4) int64 descriptor: IDENT i,
//   SHIFT (i + off) mod n, PARENT (i - 1) / k, CHILD k*i + 1 + j; right
//   wherever the edge exists, which is where the live bits lie), and a
//   packed send-liveness row set (D rows of (N + 31) / 32 int32 words,
//   node i at bit i % 32 of word i / 32), written as packed rows too.  Delivery mode: out0 = live and
//   the loss coin of src -> dst did not drop, out1 = out0 and the dup coin
//   fired.  Ledger mode (srv): out0 = live and the loss coin of dst -> src
//   (the reply) did not drop, out1 = out0 and the coin of src -> dst did
//   not either.  On a rank's block of a mesh the columns are the global
//   nodes col0 + i, whose ids the forms take.  Replaces: faults.py
//   wm_live_del (:690) and wm_srv_rows
//   (:705), XLA elementwise hashes over the (D, N) rows, some 30 int64
//   torch operations a coin in the plain version.
//
// - the scenario batch's forms of the first two (S scenarios of N rows
//   folded into one graph of S N rows, row r of scenario r / N):
//   fault_coins_kernel<true> reads each scenario's seed, thresholds and
//   active streams from an (S, 5) table and hashes the ids within the
//   scenario, clipping a source into the scenario's own rows (a -1 pad to
//   its row 0); faulted_gather_round_kernel<..., kSeg> splits the dup
//   charge by scenario: each thread's sum goes to its scenario's shared
//   word, each nonzero word to that scenario's int64 (add_segment_sums).
//   Replaces: the reference's jax.vmap of the same XLA code over the
//   scenario axis (gossip_glomers_tpu/tpu_sim/scenario.py:603).  One
//   launch each a round, whatever S is.
// - fold_freeze: the batch's freeze, in place: each active scenario's
//   rows of the state take the round's, a frozen one's stay.  Replaces:
//   certify_loop's jnp.where over the carry (scenario.py:327-337).
//
// The coin is the reference's counter hash: h = mix32(src * 0xC2B2AE35 ^
// dst * 0x27D4EB2F ^ t * 0x9E3779B9 ^ seed ^ salt), a drop iff h < loss_num
// (loss salt 0x9E3779B9, dup salt 0x85EBCA6B), in uint32 arithmetic, over
// the source index clipped into [0, n_src) as the reference clips it.
//
// Bound on the card.  fault_coins reads the index table (4 bytes an edge),
// the mask when given, and writes a byte an edge; its one random access is
// up[src], a byte per edge from a 1 MiB vector that sits in L2, so at
// (2^20 nodes, D = 8) the card's random-sector rate, not bytes or its
// integer operations, sets its floor (the gather kernels' probe: about
// 0.064 ms for 8.4 M random reads; PERF.md).  faulted_gather_round is a
// gather round (gather_flood.cu) that also reads the flag bytes and, on
// DUP edges, a second random row.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700.00 W under the nemesis phase's coins: fault_coins
// 0.064 ms (bound 0.0161, its operations), faulted_gather_round 0.068 ms
// at W = 1 and 1.93 ms at W = 128 (bounds 0.0175 and 0.654, bytes).
//
// wm_fault_coins moves only packed rows: its live rows in, one or two
// out, 0.75 MiB for the tree's two delivery rows at 2^20 nodes (0.23 us
// at 3.35 TB/s).  Its first design read two (D, N) id rows besides, 16
// MiB there (0.0110 ms against a 0.0052 ms byte bound).  The integer
// operations the function needs bound it now, at 64 lanes a clock an SM
// (132 SMs at 1.98 GHz: 16.7e12 a second): 13 a loss coin (the two id
// products, their xor with the salted key, mix32's 8, the compare), 10 a
// dup coin (it shares the products), and a slot's closed-form ids (2 for
// PARENT, 3 for SHIFT) and live bit (2).  At round 5 that is about 0.0032
// ms for the tree's 2 delivery rows and 0.0087 ms for the circulant's 8
// ledger rows (chip_smoke.py counts them from each call's coins).  This
// design spends more a slot than that: one generic formula an id, the
// votes and the word selects (open, PERF.md).
//
// Design.  wm_fault_coins: grid.y is the direction, so that a block's id
// forms are one; a warp takes 8 consecutive packed words of a row (a lane
// a node in each), so that each word's coins are one __ballot_sync, and
// the descriptor decode and the key are paid once for 256 slots.  Every
// load (the descriptor and the 8 liveness words) is issued first and no
// branch depends on a slot: each lane hashes and ANDs with its live bit
// (a branch on the bit made the compiler load the descriptor after it, two
// memory latencies in a row; a warp's lanes take the hash together
// anyway).  The coins of an edge share its ids' products.  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, 2^20 nodes at
// round 5: the tree's 2 delivery rows 0.0073 ms (from 0.0111 reading
// ids), the circulant's 8 ledger rows 0.0247 ms (from 0.0489); a word a
// warp took 0.0137 / 0.0476 ms and 4 words 0.0084 / 0.0277 (same card).
// fault_coins: one thread per edge slot, a grid-stride loop; its hashes
// (13 integer operations a coin, 8 more an edge: 0.016 ms at the integer
// rate) lie below its random-sector floor.  faulted_gather_round:
// gather_flood.cu's lane groups and launch
// geometry (a thread a node at W = 1, a lane per 16-byte vector of the row
// when W % 4 == 0 and every row is 16-byte aligned, else a lane per word,
// up to a warp a node), D = 8 a template instance with vector loads of the
// indices (two 16-byte loads) and flags (one 8-byte load) where aligned,
// any other D a generic instance four edges at a time, all payload loads
// of a chunk issued before any OR.  The dup charge is summed per thread in
// uint32, reduced per warp by shuffles and per block through shared memory,
// and added by one atomicAdd a block into the low word of a zeroed int64
// (addition mod 2^32 is order-free).  A simple kernel first: evaluating the
// coins inside this kernel, so that the flags are never written, is open.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kSend = 1, kDel = 2, kDup = 4, kOutOk = 8;
constexpr uint32_t kSaltLoss = 0x9E3779B9u, kSaltDup = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// key = t * 0x9E3779B9 ^ seed ^ salt
__device__ __forceinline__ uint32_t edge_hash(uint32_t key, uint32_t src,
                                              uint32_t dst) {
  return mix32(src * 0xC2B2AE35u ^ dst * 0x27D4EB2Fu ^ key);
}

struct Coins {
  const int32_t* nbrs;     // (n, d), the slab
  const uint8_t* live;     // (n, d), or null: an edge is live iff nbrs >= 0
  const uint8_t* up;       // (n_src,) node liveness at this round
  const long long* table;  // kTable: (n_src / block, 5) per-scenario streams
  uint8_t* flags;          // (n, d)
  int64_t edges;           // n * d
  int32_t d, n_src, row0, block;
  uint32_t t, seed, loss_num, dup_num;
  int32_t loss, dup, out_ok;  // streams active this round
};

// kTable: the scenario batch's coins, S scenarios folded into one graph
// of S * N rows (block = N), row r of scenario s = r / N.  Each
// scenario's streams come from its row of the (S, 5) int64 table: seed,
// loss_num, dup_num and whether loss and dup are active this round.  The
// hash takes the ids within the scenario (dst - s N, src - s N), and a
// source index is clipped into the scenario's own rows (a -1 pad to its
// row 0, which the OUT_OK coin reads), so each scenario draws exactly the
// coins of its one-scenario call.  Without the table the graph is one
// scenario of n_src rows, its streams the scalars.
template <bool kTable>
__global__ void __launch_bounds__(kThreads) fault_coins_kernel(const Coins c) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < c.edges; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int32_t raw = __ldg(c.nbrs + e);
    const int32_t row = c.row0 + static_cast<int32_t>(e / c.d);
    int32_t base = 0, block = c.n_src;
    uint32_t seed = c.seed, loss_num = c.loss_num, dup_num = c.dup_num;
    bool loss = c.loss != 0, dup = c.dup != 0;
    if (kTable) {
      const int32_t s = row / c.block;
      const long long* tab = c.table + 5 * static_cast<int64_t>(s);
      base = s * c.block;
      block = c.block;
      seed = static_cast<uint32_t>(__ldg(tab));
      loss_num = static_cast<uint32_t>(__ldg(tab + 1));
      dup_num = static_cast<uint32_t>(__ldg(tab + 2));
      loss = __ldg(tab + 3) != 0;
      dup = __ldg(tab + 4) != 0;
    }
    const int32_t local = raw - base;
    const uint32_t dst = static_cast<uint32_t>(row - base);
    const uint32_t src = static_cast<uint32_t>(
        raw < 0 || local < 0 ? 0 : (local >= block ? block - 1 : local));
    const uint32_t key = c.t * 0x9E3779B9u ^ seed;
    const bool live = c.live != nullptr ? __ldg(c.live + e) != 0 : raw >= 0;
    uint8_t f = 0;
    if (live && __ldg(c.up + row) != 0 && __ldg(c.up + base + src) != 0) {
      f = kSend;
      if (!loss || edge_hash(key ^ kSaltLoss, src, dst) >= loss_num) {
        f |= kDel;
        if (dup && edge_hash(key ^ kSaltDup, src, dst) < dup_num) f |= kDup;
      }
    }
    if (c.out_ok && (!loss || edge_hash(key ^ kSaltLoss, dst, src) >= loss_num))
      f |= kOutOk;
    c.flags[e] = f;
  }
}

// The id forms of a coin direction (kernels.COIN_*; 0 is IDENT): a
// descriptor row is (sender form, its argument, receiver form, its
// argument), int64 each.
constexpr int kShift = 1, kParent = 2, kChild = 3;

// One id form, decoded to id(i) = ((i + add) >> sh) * mul + off, less
// wrap where that is >= wrap (wrap 0: none): IDENT i; SHIFT(a) (i + a)
// mod n, a in [0, n); PARENT(k) (i - 1) / k, a shift for k a power of
// two, else a division by div; CHILD(k, j) k * i + 1 + j.  The form is
// the block's own (grid.y is the direction), so div's branch is uniform.
struct IdForm {
  uint32_t add, mul, off, wrap, div;
  int sh;
};

__device__ __forceinline__ IdForm id_form(long long form, long long arg,
                                          uint32_t n) {
  const uint32_t a = static_cast<uint32_t>(arg);
  const uint32_t j =
      static_cast<uint32_t>(static_cast<unsigned long long>(arg) >> 32);
  IdForm f{0u, 1u, 0u, 0u, 0u, 0};
  if (form == kShift) {
    f.add = a;
    f.wrap = n;
  } else if (form == kParent && (a & (a - 1u)) == 0u) {
    f.add = 0xFFFFFFFFu;                  // i - 1
    f.sh = __ffs(a) - 1;
  } else if (form == kParent) {
    f.div = a;
  } else if (form == kChild) {
    f.mul = a;
    f.off = 1u + j;
  }
  return f;
}

// The id of node i < n under f, in uint32 arithmetic (kernels.
// coin_dir_rows computes the same values; i + add < 2n <= 2^32).
__device__ __forceinline__ uint32_t node_id(const IdForm& f, uint32_t i) {
  if (f.div != 0u) return (i - 1u) / f.div;
  const uint32_t v = ((i + f.add) >> f.sh) * f.mul + f.off;
  return v - (v >= f.wrap ? f.wrap : 0u);
}

struct WmCoins {
  const long long* dirs;  // (d, 4) int64 descriptor rows
  const uint32_t* live;   // (d, nw) packed send liveness
  uint32_t* out0;         // (d, nw) packed
  uint32_t* out1;         // (d, nw) packed, or null (delivery mode, no dup)
  uint32_t nw, n, t, seed, loss_num, dup_num;
  uint32_t col0, n_ids;    // column i is node col0 + i of n_ids (a rank's
                           // block on a mesh; 0 and n off a mesh)
  int32_t loss, dup, srv;  // streams active this round; ledger mode
};

// A warp takes kWords consecutive packed words of its row (32 nodes a
// word, a lane a node); each word's coins are one __ballot_sync.  No
// branch depends on a slot: every lane computes its ids and coins and
// ANDs them with its live bit, so the row's descriptor and the kWords
// liveness words are loaded first and together (a branch on the bit made
// the compiler load the descriptor after it: two memory latencies in a
// row).  A warp's lanes take their hashes together either way, unless
// the whole warp is dead.  The coins of one edge share its ids' products
// (the hash is mix32(src * C1 ^ dst * C2 ^ key ^ salt)).  The decode and
// the key are paid once for the kWords words, and lane q stores word q
// (8 words a warp measured 10-11% faster than 4, and 4 about 40% faster
// than 1, on an H100; PERF.md).
constexpr int kWords = 8;

__global__ void __launch_bounds__(kThreads) wm_fault_coins_kernel(
    const WmCoins c) {
  const uint32_t row = blockIdx.y;
  const long long* desc = c.dirs + 4 * row;
  const long long d0 = __ldg(desc), d1 = __ldg(desc + 1);
  const long long d2 = __ldg(desc + 2), d3 = __ldg(desc + 3);
  const int lane = threadIdx.x & 31;
  const uint32_t word0 =
      (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kWords;
  const uint32_t* live = c.live + static_cast<int64_t>(row) * c.nw;
  uint32_t bits[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q)
    bits[q] = word0 + q < c.nw ? __ldg(live + word0 + q) : 0u;
  // decoded after every load is issued: its branches would hold back
  // the loads behind them
  const IdForm fs = id_form(d0, d1, c.n_ids), fr = id_form(d2, d3, c.n_ids);
  const uint32_t key = c.t * 0x9E3779B9u ^ c.seed;
  const uint32_t key_loss = key ^ kSaltLoss, key_dup = key ^ kSaltDup;
  uint32_t w0[kWords], w1[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint32_t i = (word0 + q) * 32 + lane;  // >= n past the row
    // bitwise & and |: a short-circuit would branch on the slot
    const bool lv = (i < c.n) & ((bits[q] >> lane) & 1u);
    const uint32_t s = node_id(fs, c.col0 + i), r = node_id(fr, c.col0 + i);
    const uint32_t x = s * 0xC2B2AE35u ^ r * 0x27D4EB2Fu;
    const bool fwd = !c.loss | (mix32(x ^ key_loss) >= c.loss_num);
    bool b0, b1;
    if (c.srv) {                            // the flags are uniform
      b0 = lv & (!c.loss
                 | (mix32(r * 0xC2B2AE35u ^ s * 0x27D4EB2Fu ^ key_loss)
                    >= c.loss_num));
      b1 = b0 & fwd;
    } else {
      b0 = lv & fwd;
      b1 = c.dup ? b0 & (mix32(x ^ key_dup) < c.dup_num) : false;
    }
    w0[q] = __ballot_sync(0xffffffffu, b0);
    w1[q] = __ballot_sync(0xffffffffu, b1);
  }
  uint32_t v0 = w0[0], v1 = w1[0];
#pragma unroll
  for (int q = 1; q < kWords; ++q) {
    v0 = lane == q ? w0[q] : v0;
    v1 = lane == q ? w1[q] : v1;
  }
  const uint32_t word = word0 + lane;
  if (lane < kWords && word < c.nw) {
    const int64_t at = static_cast<int64_t>(row) * c.nw + word;
    c.out0[at] = v0;
    if (c.out1 != nullptr) c.out1[at] = v1;
  }
}

struct Round {
  const uint32_t* payload;   // (n_src, w)
  const uint32_t* received;  // (n_src, w): the dup rows, or null (no dup)
  const uint32_t* rec;       // (n, w), the slab's received
  const int32_t* nbrs;       // (n, d), the slab
  const uint8_t* flags;      // (n, d), the slab's
  uint32_t* new_out;         // (n, w)
  uint32_t* rec_out;         // (n, w)
  uint32_t* dup_pc;          // low word of a zeroed int64 (batched: of
                             // scenario s's, at word 2 s)
  int32_t n, n_src, d;
  int32_t block;       // rows a scenario (the batched charge), else 0
  int32_t units;       // units of a row: W words, or W / 4 vectors
  int32_t group_log2;  // lanes per node row: 1 << group_log2 (<= 32)
  bool idx_vec;        // D = 8 index rows 16-byte aligned
  bool flag_vec;       // D = 8 flag rows 8-byte aligned
};

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

// Edges [e0, e0 + kChunk) of slab row i: clipped source rows and flags
// (0 past the degree).
template <int kD, int kChunk>
__device__ __forceinline__ void edges(const Round& a, int32_t i, int e0,
                                      int d, int32_t (&j)[kChunk],
                                      uint32_t (&f)[kChunk]) {
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
      raw[q] = (kD > 0 || e0 + q < d) ? __ldg(a.nbrs + at + q) : 0;
  }
  if (kD == 8 && a.flag_vec) {
    const uint2 m = __ldg(reinterpret_cast<const uint2*>(a.flags + at));
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      f[q] = (q < 4 ? m.x >> (8 * q) : m.y >> (8 * (q - 4))) & 0xFFu;
  } else {
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      f[q] = (kD > 0 || e0 + q < d) ? __ldg(a.flags + at + q) : 0u;
  }
#pragma unroll
  for (int q = 0; q < kChunk; ++q)
    j[q] = raw[q] < 0 ? 0 : (raw[q] >= a.n_src ? a.n_src - 1 : raw[q]);
}

// The dup charge's block reduction: one atomicAdd a block.
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

// The batched dup charge: the block's rows span scenarios [s_lo, s_hi]
// (at most kThreads + 1 of them: a block serves at most kThreads nodes),
// so each thread adds its node's sum into its scenario's shared word and
// the block then adds each nonzero word into that scenario's int64, one
// atomicAdd a scenario a block.  The launch covers every node in one pass
// (no grid cap), so a thread has at most one node.
__device__ __forceinline__ void add_segment_sums(uint32_t s, int64_t node,
                                                 int64_t first, int64_t last,
                                                 int32_t block,
                                                 uint32_t* out) {
  __shared__ uint32_t seg[kThreads + 1];
  for (int k = threadIdx.x; k <= kThreads; k += kThreads) seg[k] = 0u;
  __syncthreads();
  const int64_t s_lo = first / block;
  if (node >= 0 && s != 0u) atomicAdd(&seg[node / block - s_lo], s);
  __syncthreads();
  const int64_t span = last / block - s_lo + 1;
  for (int64_t k = threadIdx.x; k < span; k += kThreads)
    if (seg[k] != 0u) atomicAdd(out + 2 * (s_lo + k), seg[k]);
}

// kOne: W = 1, a thread per node.  The W = 1 instance may hold 42
// registers a thread (6 blocks an SM), the others 128 (2 blocks): each
// chunk keeps its payload and its dup rows in flight at once.  kSeg: the
// scenario batch's per-scenario dup charge (add_segment_sums) instead of
// one sum.
template <bool kVec, bool kOne, int kD, bool kSeg>
__global__ void __launch_bounds__(kThreads, kOne ? 6 : 2)
    faulted_gather_round_kernel(const Round a) {
  using U = typename UnitOf<kVec>::T;
  constexpr int kChunk = kD > 0 ? kD : 4;
  const int glog = kOne ? 0 : a.group_log2;
  const int group = 1 << glog;
  const int lane_g = kOne ? 0 : threadIdx.x & (group - 1);
  const int per_block = kThreads >> glog;
  const int32_t units = kOne ? 1 : a.units;
  const int d = kD > 0 ? kD : a.d;
  const bool dup = a.received != nullptr;
  const U* payload = reinterpret_cast<const U*>(a.payload);
  const U* received = reinterpret_cast<const U*>(a.received);
  const U* rec = reinterpret_cast<const U*>(a.rec);
  U* new_out = reinterpret_cast<U*>(a.new_out);
  U* rec_out = reinterpret_cast<U*>(a.rec_out);
  uint32_t sum = 0u;
  int64_t mine_node = -1;
  for (int64_t node = static_cast<int64_t>(blockIdx.x) * per_block
                      + (threadIdx.x >> glog);
       node < a.n; node += static_cast<int64_t>(gridDim.x) * per_block) {
    const int32_t i = static_cast<int32_t>(node);
    mine_node = node;
    const int64_t row = static_cast<int64_t>(i) * units;
    for (int c = lane_g; c < units; c += group) {
      const U mine = __ldg(rec + row + c);
      U acc = zero_unit(U{});
      for (int e0 = 0; e0 < d; e0 += kChunk) {
        int32_t j[kChunk];
        uint32_t f[kChunk];
        edges<kD, kChunk>(a, i, e0, d, j, f);
        U x[kChunk], y[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          const int64_t at = static_cast<int64_t>(j[q]) * units + c;
          x[q] = (f[q] & kDel) ? __ldg(payload + at) : zero_unit(U{});
          y[q] = (dup && (f[q] & kDup)) ? __ldg(received + at)
                                        : zero_unit(U{});
        }
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          acc = or_unit(acc, or_unit(x[q], y[q]));
          sum += popc_unit(y[q]);
        }
      }
      const U fresh = andnot_unit(acc, mine);
      new_out[row + c] = fresh;
      rec_out[row + c] = or_unit(mine, fresh);
    }
  }
  if (!dup) return;  // uniform over the block
  if (kSeg) {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
    const int64_t last =
        (first + per_block < a.n ? first + per_block : a.n) - 1;
    add_segment_sums(sum, mine_node, first, last, a.block, a.dup_pc);
  } else {
    add_block_sum(sum, a.dup_pc);
  }
}

// The scenario batch's freeze, in place: the rows of each active
// scenario s (rows [s block, (s + 1) block)) of dst0 / dst1 take src0 /
// src1's, a frozen scenario's rows stay.  A thread a unit (a 16-byte
// vector where every row is aligned and W % 4 == 0, else a word), a
// grid-stride loop; the scenario's flag byte is read a unit (it stays in
// L1).  Only the active rows move: 2 x 2 x their bytes.
struct Freeze {
  uint32_t* dst0;
  const uint32_t* src0;
  uint32_t* dst1;        // or null: one pair
  const uint32_t* src1;
  const uint8_t* active;  // (S,)
  int64_t units;          // rows * units a row
  int32_t row_units, block;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads) fold_freeze_kernel(
    const Freeze f) {
  using U = typename UnitOf<kVec>::T;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < f.units; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = e / f.row_units;
    if (__ldg(f.active + row / f.block) == 0) continue;
    reinterpret_cast<U*>(f.dst0)[e] =
        __ldg(reinterpret_cast<const U*>(f.src0) + e);
    if (f.dst1 != nullptr)
      reinterpret_cast<U*>(f.dst1)[e] =
          __ldg(reinterpret_cast<const U*>(f.src1) + e);
  }
}

using Kernel = void (*)(const Round);

template <int kD, bool kSeg>
Kernel pick_d(bool vec, bool one) {
  if (vec) return faulted_gather_round_kernel<true, false, kD, kSeg>;
  if (one) return faulted_gather_round_kernel<false, true, kD, kSeg>;
  return faulted_gather_round_kernel<false, false, kD, kSeg>;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Lanes per node row, as a power of two: one per unit, at most a warp
// (gather_flood.cu's geometry).
int group_log2_of(int64_t units) {
  int g = 0;
  while ((int64_t{1} << g) < (units < 32 ? units : 32)) ++g;
  return g;
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it cannot take).  The caller guarantees
// device pointers to contiguous buffers: (n, d) int32 nbrs and (n, d) bytes
// live and flags, (n_src,) bytes up with row0 + n <= n_src; (n_src, w)
// payload and received, (n, w) rec and outputs, 4-byte aligned; for the
// round a dup_pc word that it zeroed on the same stream.

// table null: one scenario, its streams the scalars (block unused);
// else the scenario batch's coins: nbrs over the folded rows, up (n_src,)
// folded, table (n_src / block, 5) int64, the scalars unused.
extern "C" int gg_fault_coins(const void* nbrs, const void* live,
                              const void* up, const void* table, void* flags,
                              int64_t n, int d, int64_t n_src, int64_t row0,
                              int64_t block, int64_t t, int64_t seed,
                              int64_t loss_num, int64_t dup_num, int loss,
                              int dup, int out_ok, void* stream) {
  if (n < 1 || d < 1 || n_src < 1 || row0 < 0 || row0 + n > n_src
      || n_src >= (int64_t{1} << 31)
      || (table != nullptr && (block < 1 || n_src % block != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Coins c;
  c.nbrs = static_cast<const int32_t*>(nbrs);
  c.live = static_cast<const uint8_t*>(live);
  c.up = static_cast<const uint8_t*>(up);
  c.table = static_cast<const long long*>(table);
  c.flags = static_cast<uint8_t*>(flags);
  c.edges = n * d;
  c.d = d;
  c.n_src = static_cast<int32_t>(n_src);
  c.row0 = static_cast<int32_t>(row0);
  c.block = static_cast<int32_t>(table != nullptr ? block : n_src);
  c.t = static_cast<uint32_t>(t);
  c.seed = static_cast<uint32_t>(seed);
  c.loss_num = static_cast<uint32_t>(loss_num);
  c.dup_num = static_cast<uint32_t>(dup_num);
  c.loss = loss;
  c.dup = dup;
  c.out_ok = out_ok;
  int64_t blocks = (c.edges + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  const auto kernel = table != nullptr ? fault_coins_kernel<true>
                                       : fault_coins_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// dirs: (d, 4) int64 descriptor rows (kernels.coin_dirs); live, out0 and
// out1 (null: not written) (d, ceil(n / 32)) int32 packed rows of the n
// columns col0 .. col0 + n - 1 of a graph of n_ids nodes.
extern "C" int gg_wm_fault_coins(const void* dirs, const void* live,
                                 void* out0, void* out1, int64_t d,
                                 int64_t n, int64_t col0, int64_t n_ids,
                                 int64_t t, int64_t seed, int64_t loss_num,
                                 int64_t dup_num, int loss, int dup, int srv,
                                 void* stream) {
  if (n < 1 || col0 < 0 || n_ids >= (int64_t{1} << 31) || col0 + n > n_ids
      || d < 1 || d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  WmCoins c;
  c.dirs = static_cast<const long long*>(dirs);
  c.live = static_cast<const uint32_t*>(live);
  c.out0 = static_cast<uint32_t*>(out0);
  c.out1 = static_cast<uint32_t*>(out1);
  c.nw = static_cast<uint32_t>((n + 31) / 32);
  c.n = static_cast<uint32_t>(n);
  c.col0 = static_cast<uint32_t>(col0);
  c.n_ids = static_cast<uint32_t>(n_ids);
  c.t = static_cast<uint32_t>(t);
  c.seed = static_cast<uint32_t>(seed);
  c.loss_num = static_cast<uint32_t>(loss_num);
  c.dup_num = static_cast<uint32_t>(dup_num);
  c.loss = loss;
  c.dup = dup;
  c.srv = srv;
  const int64_t per_block = kThreads / 32 * kWords;
  const dim3 grid(static_cast<unsigned>((c.nw + per_block - 1) / per_block),
                  static_cast<unsigned>(d));
  wm_fault_coins_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

namespace {

int launch_round(const void* payload, const void* received, const void* rec,
                 const void* nbrs, const void* flags, void* new_out,
                 void* rec_out, void* dup_pc, int64_t n, int64_t w,
                 int64_t n_src, int d, int64_t block, void* stream) {
  if (n < 1 || n_src < 1 || d < 1 || w < 1 || n >= (int64_t{1} << 31)
      || n_src >= (int64_t{1} << 31) || w >= (int64_t{1} << 31)
      || block < 0 || block >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Round a;
  a.payload = static_cast<const uint32_t*>(payload);
  a.received = static_cast<const uint32_t*>(received);
  a.rec = static_cast<const uint32_t*>(rec);
  a.nbrs = static_cast<const int32_t*>(nbrs);
  a.flags = static_cast<const uint8_t*>(flags);
  a.new_out = static_cast<uint32_t*>(new_out);
  a.rec_out = static_cast<uint32_t*>(rec_out);
  a.dup_pc = static_cast<uint32_t*>(dup_pc);
  a.n = static_cast<int32_t>(n);
  a.n_src = static_cast<int32_t>(n_src);
  a.d = d;
  a.block = static_cast<int32_t>(block);
  const bool vec = w % 4 == 0 && aligned(payload, 16) && aligned(rec, 16)
                   && aligned(new_out, 16) && aligned(rec_out, 16)
                   && (received == nullptr || aligned(received, 16));
  a.units = static_cast<int32_t>(vec ? w / 4 : w);
  a.group_log2 = group_log2_of(a.units);
  a.idx_vec = d == 8 && aligned(nbrs, 16);
  a.flag_vec = d == 8 && aligned(flags, 8);
  const int per_block = kThreads >> a.group_log2;
  const int64_t blocks = (n + per_block - 1) / per_block;
  const bool one = w == 1;
  const Kernel k =
      block > 0 ? (d == 8 ? pick_d<8, true>(vec, one)
                          : pick_d<0, true>(vec, one))
                : (d == 8 ? pick_d<8, false>(vec, one)
                          : pick_d<0, false>(vec, one));
  k<<<static_cast<unsigned>(blocks), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gg_faulted_gather_round(const void* payload,
                                       const void* received,
                                       const void* rec, const void* nbrs,
                                       const void* flags, void* new_out,
                                       void* rec_out, void* dup_pc,
                                       int64_t n, int64_t w, int64_t n_src,
                                       int d, void* stream) {
  return launch_round(payload, received, rec, nbrs, flags, new_out, rec_out,
                      dup_pc, n, w, n_src, d, 0, stream);
}

// The scenario batch's round: the same, with dup_pc an (n / block,) int64
// array, scenario s's charge (its rows [s block, (s + 1) block)) in the low
// word of element s.  The slab starts at a scenario's first row.
extern "C" int gg_faulted_gather_round_batched(
    const void* payload, const void* received, const void* rec,
    const void* nbrs, const void* flags, void* new_out, void* rec_out,
    void* dup_pc, int64_t n, int64_t w, int64_t n_src, int d, int64_t block,
    void* stream) {
  if (block < 1 || n % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_round(payload, received, rec, nbrs, flags, new_out, rec_out,
                      dup_pc, n, w, n_src, d, block, stream);
}

// dst0, src0 (and dst1, src1, or null) (rows, w) int32 rows, 4-byte
// aligned, active (rows / block,) bytes.
extern "C" int gg_fold_freeze(void* dst0, const void* src0, void* dst1,
                              const void* src1, const void* active,
                              int64_t rows, int64_t w, int64_t block,
                              void* stream) {
  if (rows < 1 || w < 1 || block < 1 || rows % block != 0
      || w >= (int64_t{1} << 31) || block >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && aligned(dst0, 16) && aligned(src0, 16)
                   && (dst1 == nullptr
                       || (aligned(dst1, 16) && aligned(src1, 16)));
  Freeze f;
  f.dst0 = static_cast<uint32_t*>(dst0);
  f.src0 = static_cast<const uint32_t*>(src0);
  f.dst1 = static_cast<uint32_t*>(dst1);
  f.src1 = static_cast<const uint32_t*>(src1);
  f.active = static_cast<const uint8_t*>(active);
  f.row_units = static_cast<int32_t>(vec ? w / 4 : w);
  f.units = rows * f.row_units;
  f.block = static_cast<int32_t>(block);
  int64_t blocks = (f.units + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  if (vec)
    fold_freeze_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(f);
  else
    fold_freeze_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// Nodes a block of faulted_gather_round serves at W words a node, on rows
// the vector path takes when `vec` (kernels.gather_nodes_per_block).
extern "C" int gg_faulted_nodes_per_block(int64_t w, int vec) {
  return kThreads >> group_log2_of(vec && w % 4 == 0 ? w / 4 : w);
}
