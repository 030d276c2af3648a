// Hand-written Hopper (sm_90a) kernels of the words-major shift
// topologies: circulant, ring, line and grid.
//
// Bitsets are (W, N) words-major: word w of node i sits at w * N + i.
// Every one of these topologies delivers node i's inbox as the OR over a
// small table of directions, each a constant node offset:
//
//   inbox[w, i] = OR_d  payload[w, i + o_d]
//
// A direction either wraps (ring and circulant rotations: i + o_d is taken
// mod n) or shifts with zero fill (line and grid: a source outside [0, n)
// delivers nothing).  Grid left/right directions also carry a column
// mask, which kills the row wrap-around: "left" (o = +1) only where
// i % cols < cols - 1, "right" (o = -1) only where i % cols > 0.
//
// Replaces: the XLA code of gossip_glomers_tpu/tpu_sim/structured.py
// grid_terms / grid_exchange, line_terms / line_exchange, ring_exchange
// and circulant_exchange (:170-222), each a few rolls or shifted
// concatenations ORed together, and the _flood_loop body over them
// (broadcast.py:285-289).  No Pallas kernel stood there.  The masked
// exchange (gg_shift_masked_exchange) replaces grid_masked_exchange,
// circulant_masked_exchange and line_masked_exchange (:688-720) and the
// ring, circulant, grid and line branches of _nem_closures' exchange
// (:1780-1873): direction d's term at receiver i counts only where bit i
// of the d-th packed liveness row is set ((N + 31) / 32 int32 words a
// row, node i at bit i % 32 of word i / 32: the circulant's 8 rows are
// 1 MiB at 2^20 nodes, a quarter of its W = 1 bitset).  Each tile stages
// its slice of every liveness row beside its windows (see "The masked
// exchange" below).
//
// Bound on the card: memory bytes.  A word costs a handful of integer
// operations per direction against 4 bytes moved; the exchange must read
// the payload once and write the inbox once (2 bitsets), the fused round
// reads frontier and received and writes received and the next frontier
// (4 bitsets).  Above that bound sits L2: the circulant's rotations lie
// far apart, so each payload word travels from L2 to the SMs once per
// window (7 times at 2^20 nodes) whatever the design.  A thread per node
// with one 4-byte load per direction delivered that traffic at about
// 2 TB/s; what moves it faster is bytes in flight in large requests.
//
// Design: a row is cut into tiles of T consecutive nodes (T <= 2048).
// The inbox of tile [i0, i0 + T) reads, for each direction, the
// contiguous source range [i0 + o_d, i0 + o_d + T).  The host merges the
// directions whose offsets lie within T of each other into one window
// [i0 + lo, i0 + hi + T) (kernels.shift_windows: the circulant at 2^20
// has 7 windows, ring and line 1, the grid 1 of T + 2 cols words), and
// each tile stages its windows, and in the fused round its own received
// words, into shared memory by 1-D bulk copies (TMA, cp.async.bulk).
// Persistent blocks, as many as fit on each SM, walk the tiles in
// row-major order through a ring of stages in dynamic shared memory (up
// to 227 KB a block).  In each block one producer warp works out a
// tile's copies, one lane per window, arms the stage's "full" mbarrier
// with their bytes and issues them, once the eight consumer warps have
// released the stage on its "empty" mbarrier; a small descriptor tells
// the consumers where each direction's words landed.  The consumers OR
// the directions out of shared memory (consecutive threads, consecutive
// words: no bank conflicts), their count a template parameter (padded to
// a power of two with copies, which the OR absorbs), and write received
// and the next frontier with coalesced stores.
//
// A bulk copy needs a 16-byte aligned global address and a length in
// 16-byte units, and a row starts 16-byte aligned only when n % 4 == 0 (a
// view may also start 4 bytes into its allocation).  So a window is
// copied as the aligned chunks that cover it and lie inside the tensor,
// placed at its 16-byte phase in its stage slot (the consumers add the
// phase); nothing is read past either end of the tensor.  A wrap window
// that crosses n is two copies when its row starts and ends on the
// 16-byte grid (the main path's case); otherwise, and for a zero-fill
// window that leaves the row, the consumers fill it word by word, mod n
// or with zeros.  That happens to a few tiles per row, and to every tile
// of a row shorter than T.  All indices are 64-bit: W * N passes 2^31 at
// the main path's W = 128, N = 2^20.  received is updated in place (a
// tile reads and writes only its own received words); the next frontier
// goes to a second buffer, because a tile reads its neighbours' frontier
// words.
//
// The masked exchange.  It moves the exchange's 2 bitsets and the D
// packed rows (D * N / 8 bytes, once: an eighth more bytes than the
// exchange at W = 1 with 8 rows).  Its first design read each
// direction's liveness word from global memory beside the staged source
// word, and skipped the term by a branch when the bit was clear: D
// dependent loads a word, each holding back its shared-memory load, at
// an address from a 64-bit multiply.  At
// (1, 2^20) with the circulant's 8 rows it took 0.0346 ms, 8% of its
// 0.00282 ms bound and 4.1x the unmasked exchange (0.0084) in the same
// run (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py).  Now the producer
// stages each tile's slice of every row — words [i0 / 32, (i0 + tl + 31)
// / 32), 64 words a row at T = 2048, on the stage's own full barrier —
// into one slot a row after the windows (the plan's live_at), copied and
// filled as the windows are, and the consumers AND each term with its
// bit spread to a mask: the D shared loads of a word go out together.
// A warp's 32 consecutive nodes take their bits from one or two slice
// words a direction (two when the tile starts inside a word), which
// shared memory broadcasts.  At (1, 2^20) it takes 0.0106 ms, 1.24x the
// unmasked exchange, and at (128, 2^20) 0.935 ms, 1.13-1.20x (the stage
// grows by 4%).  Rejected, all slower at both shapes: smaller tiles,
// which give an SM 2-4 blocks (cap 1024: 0.0113 / 1.166 ms; 512: 0.0135
// / 1.419), and a consumer that took a warp's 8 slice words of a
// direction in two 16-byte loads, directions outermost (0.0127 / 1.12);
// a sign-bit shift in place of the bit's shift, AND and negation changed
// nothing (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py time_kernels).
//
// The ring mode (gg_shift_ring_exchange, per-hop latency).  Replaces the XLA
// code of the reference's delayed shift deliveries (structured.py
// _delayed_impl :1038 and make_edge_delayed :1335, and _round_wm_nem's delayed
// branch, broadcast.py:858-881): each row of the direction table reads its own
// slot of the (L, W, N) payload ring (its send round's payload), under its own
// optional liveness row (a row a (direction, delay class): the circulant's 8
// directions x 2 classes are 16 rows).  Bound: the bytes, each slot read once,
// each row once, the inbox written once; above it, L2-to-SM delivery, each
// slot's payload word once per window of that slot.  A window belongs to one
// slot (kernels.shift_windows keys on (slot, wrap)), so the 16 rows make 14
// windows.  The unit of the stage ring is (tile, group): the host groups
// the rows by slot (kernels.shift_groups, at most 16 a group), each group
// with its windows and its rows' slices, and the producer stages one group
// a stage — one slot's masked exchange, 59,648 bytes at the 2048-node tile,
// so two stages fit and the tile stays 2048 (staging all of a tile's slots
// at once overflows shared memory at that tile).  The consumers keep the
// tile's inbox words in registers across its groups, OR each group's terms
// in, release its stage, and store the words once, with the tile's last
// group; so the plan caps the tile at one consumer pass (kUnroll 8 x 256
// consumers: 2048 nodes).  Up to 32 rows run in one launch (the 3-class
// circulant's 24); the wrapper splits a longer table and ORs the inboxes.
// A one-source plan is one group, with the same plan words, tile and
// stages as the ring's one-slot case.  Its kernels are compiled apart
// (kRing false: the group's indices are constants), and the producer
// counts its stage and group rather than dividing the unit index: both
// keep the one-source kernels at their own speed.  The ring kernel takes
// 0.0187 ms at (1, 2^20) and 1.851 ms at (128, 2^20), 23% and 26% of its
// bound and 59% and 76% of the L2 floor (14 windows of a slot at the L2
// probe's 5.33 TB/s: 0.0110 / 1.410 ms); the two masked launches it
// replaces take 0.0217 / 1.844 ms on the device (NVIDIA H100 80GB HBM3,
// 700.00 W, chip_smoke.py time_kernels).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumers = 256;              // 8 warps read the stages
constexpr int kThreads = kConsumers + 32;    // and one warp fills them
constexpr int kUnroll = 8;                   // words a consumer thread
                                             // takes per tile
constexpr int kMaxTile = kConsumers * kUnroll;  // one pass covers a tile
constexpr int kMaxDirs = 16;   // directions of a group (the consumers' N)
constexpr int kMaxRows = 32;   // directions (ring-table rows) of a plan
constexpr int kMaxGroups = kMaxRows;
constexpr int kMaxStages = 4;
// dynamic shared memory a block may ask for: the card's 227 KB less room
// for the static barriers and descriptors
constexpr int kMaxSmemBytes = 227 * 1024 - 1024;

// direction flags
constexpr int kMaskLeft = 2;   // only where i % cols < cols - 1
constexpr int kMaskRight = 4;  // only where i % cols > 0

// The staging plan of one direction table at one n (kernels.py,
// _shift_plan): windows, where each sits in its group's stage, per
// direction its window's lo and shared-memory offset (so the device never
// indexes one table by another), and the groups.  A group is the unit a
// stage holds: a run of windows of one source (one ring slot) and the
// directions that read them, at most kMaxDirs; a one-source plan is one
// group.  The consumers pad a group's directions to a power of two with
// copies of its first (the OR absorbs them).
struct Plan {
  int64_t lo[kMaxRows];     // window k stages [i0 + lo, i0 + lo + span + tl)
  int64_t dlo[kMaxRows];    // lo of direction e's window
  int64_t gsoff[kMaxGroups];  // group g's source: word slot * W * N of the
                              // (L, W, N) ring (0 for one source)
  int64_t cols;             // grid width (0: no column masks)
  int64_t src_words;        // words of the source tensor (L * W * N)
  int32_t span[kMaxRows];   // window k: hi - lo
  int32_t wrap[kMaxRows];   // window k: 1 = mod n, 0 = zero fill
  int32_t at[kMaxRows];     // window k: word offset in a stage (x4)
  int32_t dwrap[kMaxRows];  // direction e: its window's wrap
  int32_t dat[kMaxRows];    // direction e: its window's offset in a stage
  int32_t ddelta[kMaxRows]; // direction e: o_e - lo of its window
  int32_t dmask[kMaxRows];  // direction e: column-mask flags
  int32_t dlive[kMaxRows];  // direction e: its liveness row
  int32_t gwin[kMaxGroups];   // group g: its first window
  int32_t gnwin[kMaxGroups];  // group g: its windows
  int32_t gdir[kMaxGroups];   // group g: its first direction
  int32_t gndir[kMaxGroups];  // group g: its directions
  int32_t glive[kMaxGroups];  // group g: its liveness slots' offset in a
                              // stage (x4; -1: the plan stages none)
  int32_t n_win, n_rows, n_groups;
  int32_t n_dirs;           // the largest group's directions, padded to a
                            // power of two (the template N); 0: no direction
  int32_t tile;             // nodes per tile, 1 <= tile <= min(n, kMaxTile)
  int32_t stages;           // (tile, group) units in flight per block
  int32_t stage_words;      // words of one stage (x4)
  int32_t rec_at;           // received's offset in a stage (fused round)
  int32_t live_slot;        // words a liveness row's slice slot (x4)
  int32_t n_live;           // rows of the liveness tensor: the directions
};

// host layout of the plan (int64 words), mirrored by kernels.py: a head
// of tile, stages, stage_words, rec_at, cols, n_win, n_rows, live_at; per
// window lo, span, wrap, at; per direction window, delta, mask.  A
// one-source plan ends there: one group, its liveness slots from live_at
// to the stage's end, one a direction.  A ring plan goes on with the
// number of groups, a liveness slot's words (0: none), per group its ring
// slot, first window, windows, first direction, directions and liveness
// offset, and per direction its liveness row.
constexpr int kPlanHead = 8;
constexpr int kWinWords = 4;
constexpr int kDirWords = 3;
constexpr int kGroupWords = 6;

// What the producer tells the consumers about the (tile, group) unit in
// one stage: for each of the group's directions, padded to the plan's
// n_dirs, where its words and its liveness slice landed and its mask flags.
struct Desc {
  int32_t sd[kMaxDirs];  // direction d's first word in the stage
  int32_t sl[kMaxDirs];  // direction d's liveness slice in the stage
  int32_t mk[kMaxDirs];  // direction d's column-mask flags
  int32_t rec;           // received's first word in the stage
  uint32_t slow;         // bit k: the group's window k to fill word by
                         // word; bit 16 + r: its liveness row r; bit 31:
                         // received
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One staged range of one tile: `len` source words starting at row
// position s (taken mod n for a wrap window: s + lo lies in (-n, 2n)),
// i.e. tensor word row_start + s.  `ph` is that word's position in its
// 16-byte chunk, so the range sits at stage offset at + ph.  `fast` when
// bulk copies can stage it, `bytes` in all: one copy when it lies inside
// the row and the aligned chunks covering it inside the tensor; two when
// a wrap range crosses n of a row that starts and ends on the 16-byte
// grid ([s, n) of `head` bytes, then [0, s + len - n) from the row's
// start, which lands 16-byte aligned right after it).
struct Piece {
  int64_t s, g;
  int32_t ph;
  uint32_t bytes, head;
  bool fast;
};

__device__ __forceinline__ Piece piece(const uint32_t* base, int64_t total,
                                      int64_t row_start, int64_t s,
                                      int64_t len, int64_t n, bool wrap) {
  Piece p;
  if (wrap) s += s < 0 ? n : s >= n ? -n : 0;
  p.s = s;
  p.g = row_start + s;
  const uint64_t base_w = reinterpret_cast<uintptr_t>(base) >> 2;
  p.ph = static_cast<int32_t>((base_w + static_cast<uint64_t>(p.g)) & 3u);
  const int64_t words = (p.ph + len + 3) & ~int64_t{3};
  p.bytes = static_cast<uint32_t>(words * 4);
  p.head = 0;
  p.fast = s >= 0 && s + len <= n && p.g - p.ph >= 0
           && p.g - p.ph + words <= total;
  if (!p.fast && wrap && len <= n && (n & 3) == 0
      && ((base_w + static_cast<uint64_t>(row_start)) & 3u) == 0) {
    p.head = static_cast<uint32_t>((n - s + p.ph) * 4);
    p.fast = true;
  }
  return p;
}

__device__ __forceinline__ void bulk_copy(uint32_t* dst, const uint32_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The word-by-word fill of a range the copies could not stage, by the
// consumers: source positions x in [s, s + len) of the row, mod n or
// zero outside [0, n).  A wrap range starts in [0, n) and is at most 2n
// long (span <= tile <= n), so x < 3n.
__device__ __noinline__ void fill(uint32_t* dst, const uint32_t* row,
                                  int64_t s, int64_t len, int64_t n,
                                  bool wrap) {
  for (int64_t q = threadIdx.x; q < len; q += kConsumers) {
    int64_t x = s + q;
    uint32_t v = 0u;
    if (wrap) {
      while (x >= n) x -= n;
      v = row[x];
    } else if (x >= 0 && x < n) {
      v = row[x];
    }
    dst[q] = v;
  }
}

struct TileAt {
  int64_t row_start, i0, tl;
};

__device__ __forceinline__ TileAt tile_at(int64_t tile, int64_t per_row,
                                          int64_t n, int32_t t) {
  const int64_t row = tile / per_row;
  const int64_t i0 = (tile - row * per_row) * t;
  return {row * n, i0, n - i0 < t ? n - i0 : static_cast<int64_t>(t)};
}

// The liveness slice of a tile: the packed words [i0 / 32, (i0 + tl + 31)
// / 32) of each row, which hold the bits of the tile's nodes x = i0 + t
// (the bit of x, not of a tensor word: every one of the W rows stages the
// same slice).  Row r starts at r * nw of the (rows, nw) tensor.
__device__ __forceinline__ Piece live_piece(const uint32_t* live,
                                           int64_t rows, int64_t nw, int r,
                                           const TileAt& at) {
  const int64_t s = at.i0 >> 5;
  return piece(live, rows * nw, r * nw, s, ((at.i0 + at.tl + 31) >> 5) - s,
               nw, false);
}

// Tiles are dealt to the persistent blocks round robin in row-major order.
struct Walk {
  int64_t per_row, first, step, mine, total;
};

__device__ __forceinline__ Walk walk(int64_t w, int64_t n, int32_t tile) {
  Walk k;
  k.per_row = (n + tile - 1) / tile;
  const int64_t tiles = w * k.per_row;
  k.first = blockIdx.x;
  k.step = gridDim.x;
  k.mine = k.first < tiles ? (tiles - 1 - k.first) / k.step + 1 : 0;
  k.total = w * n;
  return k;
}

// The producer warp: for each of this block's (tile, group) units in
// order (a tile's groups one after another), once its stage is free, lane
// k works out the group's window k (lane 31 the received tile, lane 16 +
// r the slice of the liveness row of the group's direction r) and lane d
// the descriptor of the group's direction d; lane 0 writes the descriptor
// and arms the stage's full barrier with the bytes the copies will bring,
// and each lane starts its copies.  The stage and its phase are counted,
// not divided out of a unit index (a 64-bit division a unit, and the
// producer's work sits between a stage's release and its next copies).
template <bool kMasked, bool kFused, bool kLive, bool kRing>
__device__ __forceinline__ void produce(uint32_t* smem, uint64_t* full,
                                        uint64_t* empty, Desc* desc,
                                        const uint32_t* src,
                                        const uint32_t* received,
                                        const uint32_t* live, int64_t n,
                                        const Walk& wk, const Plan& p) {
  const int lane = threadIdx.x & 31;
  const int64_t nw = (n + 31) >> 5;
  const int groups = kRing ? p.n_groups : 1;
  int st = 0;                               // the next unit's stage
  uint32_t lap = 0;                         // and how often it was used
  for (int64_t kt = 0; kt < wk.mine; ++kt) {
    const TileAt at = tile_at(wk.first + kt * wk.step, wk.per_row, n, p.tile);
    for (int g = 0; g < groups; ++g) {
      if (lap > 0) bar_wait(&empty[st], (lap - 1) & 1u);
      // the group's windows and directions (one source: all of them)
      const int ndir = kRing ? p.gndir[g] : p.n_rows;
      const int win0 = kRing ? p.gwin[g] : 0;
      const int dir0 = kRing ? p.gdir[g] : 0;
      const int live0 = kRing ? p.glive[g] : p.glive[0];
      const bool is_win = lane < (kRing ? p.gnwin[g] : p.n_win);
      const bool is_rec = kFused && lane == 31;
      const bool is_live = kLive && lane >= 16 && lane - 16 < ndir;
      const int kw = win0 + (is_win ? lane : 0);  // this lane's window
      // the row start of the group's source in its tensor (its ring slot)
      const int64_t row0 = at.row_start + (kRing ? p.gsoff[g] : 0);
      Piece pc{};
      if (is_win)
        pc = piece(src, p.src_words, row0, at.i0 + p.lo[kw],
                   p.span[kw] + at.tl, n, p.wrap[kw] != 0);
      else if (is_rec)
        pc = piece(received, wk.total, at.row_start, at.i0, at.tl, n, false);
      else if (is_live)
        pc = live_piece(live, p.n_live, nw, p.dlive[dir0 + lane - 16], at);
      const bool mine = is_win || is_rec || is_live;
      const bool copies = mine && pc.fast;
      const uint32_t slow = __ballot_sync(~0u, mine && !pc.fast);
      const uint32_t bytes = __reduce_add_sync(~0u, copies ? pc.bytes : 0u);
      uint32_t* stage = smem + st * p.stage_words;
      int sd = 0, sl = 0, mk = 0;
      if (lane < p.n_dirs) {
        const int r = lane < ndir ? lane : 0;  // padding: the group's first
        const int e = dir0 + r;
        sd = p.dat[e] + p.ddelta[e]
             + piece(src, p.src_words, row0, at.i0 + p.dlo[e], 0, n,
                     p.dwrap[e] != 0).ph;
        if (kMasked) mk = p.dmask[e];
        if (kLive)
          sl = live0 + r * p.live_slot
               + live_piece(live, p.n_live, nw, p.dlive[e], at).ph;
      }
      const int rec = __shfl_sync(~0u, p.rec_at + pc.ph, 31);
      for (int d = 0; d < p.n_dirs; ++d) {
        const int v = __shfl_sync(~0u, sd, d);
        if (lane == 0) desc[st].sd[d] = v;
        if (kMasked) {
          const int f = __shfl_sync(~0u, mk, d);
          if (lane == 0) desc[st].mk[d] = f;
        }
        if (kLive) {
          const int u = __shfl_sync(~0u, sl, d);
          if (lane == 0) desc[st].sl[d] = u;
        }
      }
      if (lane == 0) {
        desc[st].rec = rec;
        desc[st].slow = slow;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(smem_u32(&full[st])), "r"(bytes) : "memory");
      }
      __syncwarp();
      if (copies) {
        // order the consumers' generic-proxy use of the stage (released
        // through the empty barrier) before this copy's async-proxy writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        uint32_t* dst = stage + (is_rec    ? p.rec_at
                                 : is_live ? live0 + (lane - 16) * p.live_slot
                                           : p.at[kw]);
        const uint32_t* from = is_rec ? received : is_live ? live : src;
        if (pc.head == 0) {
          bulk_copy(dst, from + (pc.g - pc.ph), pc.bytes, &full[st]);
        } else {
          bulk_copy(dst, from + (pc.g - pc.ph), pc.head, &full[st]);
          bulk_copy(dst + pc.ph + (n - pc.s), from + row0,
                    pc.bytes - pc.head, &full[st]);
        }
      }
      if (++st == p.stages) {
        st = 0;
        ++lap;
      }
    }
  }
}

// The consumers: for each tile, for each of its groups in turn, wait for the
// group's stage, fill what the copies could not stage, OR the group's N
// directions out of the stage into the tile's inbox words (word t by thread t
// % 256, kUnroll words a thread: one pass covers a tile, so the words stay in
// registers across the groups; the tile's last group stores them as it ORs
// them) and release the stage.  kLive: each term is ANDed with its liveness
// bit, read from the staged slice and spread to a mask (no branch: the N
// shared loads of a word go out together).  A warp's 32 consecutive words read
// one or two slice words a direction, which shared memory broadcasts, at any
// tile start.
template <int N, bool kMasked, bool kFused, bool kLive, bool kRing>
__device__ __forceinline__ void consume(uint32_t* smem, uint64_t* full,
                                        uint64_t* empty, const Desc* desc,
                                        const uint32_t* src,
                                        uint32_t* received, uint32_t* out,
                                        const uint32_t* live, int64_t n,
                                        const Walk& wk, const Plan& p) {
  const int64_t nw = (n + 31) >> 5;
  const int tid = threadIdx.x;
  const bool none = p.n_dirs == 0;
  const int groups = kRing ? p.n_groups : 1;
  int st = 0;                               // the next unit's stage
  uint32_t lap = 0;                         // and how often it was used
  for (int64_t kt = 0; kt < wk.mine; ++kt) {
    const TileAt at = tile_at(wk.first + kt * wk.step, wk.per_row, n, p.tile);
    const int tl = static_cast<int>(at.tl);
    const int bit0 = static_cast<int>(at.i0 & 31);  // x's bit in the slice:
                                                    // bit0 + t
    const int64_t g0 = at.row_start + at.i0;
    uint32_t acc[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) acc[j] = 0u;
    for (int g = 0; g < groups; ++g) {
      uint32_t* stage = smem + st * p.stage_words;
      bar_wait(&full[st], lap & 1u);
      const Desc& ds = desc[st];
      const uint32_t slow = ds.slow;
      if (slow) {
        const int64_t row0 = at.row_start + p.gsoff[g];
        for (int win = 0; win < p.gnwin[g]; ++win) {
          if (!(slow >> win & 1u)) continue;
          const int kw = p.gwin[g] + win;
          const bool wrap = p.wrap[kw] != 0;
          const Piece pc = piece(src, p.src_words, row0, at.i0 + p.lo[kw],
                                 p.span[kw] + at.tl, n, wrap);
          fill(stage + p.at[kw] + pc.ph, src + row0, pc.s,
               p.span[kw] + at.tl, n, wrap);
        }
        if (kFused && slow >> 31)
          fill(stage + ds.rec, received + at.row_start, at.i0, at.tl, n,
               false);
        if (kLive)
          for (int r = 0; r < p.gndir[g]; ++r) {
            if (!(slow >> (16 + r) & 1u)) continue;
            const int row = p.dlive[p.gdir[g] + r];
            const Piece pc = live_piece(live, p.n_live, nw, row, at);
            fill(stage + p.glive[g] + r * p.live_slot + pc.ph,
                 live + row * nw, pc.s, ((at.i0 + at.tl + 31) >> 5) - pc.s,
                 nw, false);
          }
        asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
      }
      const int last = groups - 1;
      const uint32_t* r = stage + ds.rec;
      const uint32_t* q[N];
      const uint32_t* lv[N];
      int mk[N];
#pragma unroll
      for (int d = 0; d < N; ++d) {
        q[d] = stage + (none ? 0 : ds.sd[d]);
        if (kLive) lv[d] = stage + (none ? 0 : ds.sl[d]);
        mk[d] = kMasked && !none ? ds.mk[d] : 0;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int t = tid + j * kConsumers;
        if (t >= tl) break;
        int64_t col = 0;
        if (kMasked) col = (at.i0 + t) % p.cols;
        uint32_t v = 0u;
        if (!(kLive && none)) {  // (a table without directions stages no
                                 // liveness slice)
#pragma unroll
          for (int d = 0; d < N; ++d) {
            if (kMasked) {
              if ((mk[d] & kMaskLeft) && col >= p.cols - 1) continue;
              if ((mk[d] & kMaskRight) && col == 0) continue;
            }
            if (kLive) {
              const int u = bit0 + t;
              v |= q[d][t] & (0u - (lv[d][u >> 5] >> (u & 31) & 1u));
            } else {
              v |= q[d][t];
            }
          }
        }
        if (g < last) {
          acc[j] |= v;
          continue;
        }
        v = none ? 0u : v | acc[j];
        if (kFused) {
          const uint32_t was = r[t];
          const uint32_t fresh = v & ~was;
          received[g0 + t] = was | fresh;
          out[g0 + t] = fresh;
        } else {
          out[g0 + t] = v;
        }
      }
      __syncwarp();
      if ((tid & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(smem_u32(&empty[st])) : "memory");
      if (++st == p.stages) {
        st = 0;
        ++lap;
      }
    }
  }
}

// kFused: the pure-flood round (src = frontier, out = frontier_next,
// received updated in place).  Else the exchange (out = inbox), under the
// packed liveness rows `live` when kLive; kRing: of a ring plan's groups
// (else of its one group, whose indices are then constants).
template <int N, bool kMasked, bool kFused, bool kLive, bool kRing>
__global__ void __launch_bounds__(kThreads, 1) shift_tiles_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ received,
    uint32_t* __restrict__ out, const uint32_t* __restrict__ live, int64_t w,
    int64_t n, const Plan p) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ Desc desc[kMaxStages];
  const Walk wk = walk(w, n, p.tile);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&empty[s])), "n"(kConsumers / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers)
    produce<kMasked, kFused, kLive, kRing>(smem, full, empty, desc, src,
                                           received, live, n, wk, p);
  else
    consume<N, kMasked, kFused, kLive, kRing>(smem, full, empty, desc, src,
                                              received, out, live, n, wk,
                                              p);
}

// Unpacks the host's plan words; false when they do not fit.  `slots` >
// 0: a ring plan over that many (w, n) slots, its groups after the
// directions; else one (w, n) source, one group.
bool unpack(const int64_t* words, int len, int64_t w, int64_t n,
            int64_t slots, Plan* p) {
  if (len < kPlanHead) return false;
  *p = Plan{};
  p->tile = static_cast<int32_t>(words[0]);
  p->stages = static_cast<int32_t>(words[1]);
  p->stage_words = static_cast<int32_t>(words[2]);
  p->rec_at = static_cast<int32_t>(words[3]);
  p->cols = words[4];
  p->n_win = static_cast<int32_t>(words[5]);
  p->n_rows = static_cast<int32_t>(words[6]);
  const int64_t live_at = words[7];
  if (p->n_win < 0 || p->n_win > kMaxRows || p->n_rows < 0
      || p->n_rows > kMaxRows || p->stages < 1 || p->stages > kMaxStages
      || p->tile < 1 || p->tile > kMaxTile || p->stage_words < 0
      || (p->stage_words & 3)
      || (p->rec_at >= 0 && ((p->rec_at & 3) || p->rec_at > p->stage_words))
      || live_at < -1 || live_at > p->stage_words
      || len < kPlanHead + kWinWords * p->n_win + kDirWords * p->n_rows)
    return false;
  const int64_t* win = words + kPlanHead;
  const int64_t* dir = win + kWinWords * p->n_win;
  const int64_t* tail = dir + kDirWords * p->n_rows;
  const int64_t rest = len - (tail - words);
  p->n_live = p->n_rows;
  if (slots > 0) {
    if (rest < 2) return false;
    if (tail[1] < 0 || tail[1] > p->stage_words) return false;
    p->n_groups = static_cast<int32_t>(tail[0]);
    p->live_slot = static_cast<int32_t>(tail[1]);
    if (p->n_groups < 1 || p->n_groups > kMaxGroups
        || rest != 2 + kGroupWords * p->n_groups + p->n_rows)
      return false;
    const int64_t* grp = tail + 2;
    const int64_t* lrow = grp + kGroupWords * p->n_groups;
    for (int g = 0; g < p->n_groups; ++g) {
      const int64_t* e = grp + kGroupWords * g;
      if (e[0] < 0 || e[0] >= slots) return false;
      p->gsoff[g] = e[0] * w * n;
      p->gwin[g] = static_cast<int32_t>(e[1]);
      p->gnwin[g] = static_cast<int32_t>(e[2]);
      p->gdir[g] = static_cast<int32_t>(e[3]);
      p->gndir[g] = static_cast<int32_t>(e[4]);
      p->glive[g] = static_cast<int32_t>(e[5]);
    }
    for (int e = 0; e < p->n_rows; ++e) {
      if (lrow[e] < 0 || lrow[e] >= p->n_rows) return false;
      p->dlive[e] = static_cast<int32_t>(lrow[e]);
    }
  } else {
    if (rest != 0) return false;
    p->n_groups = 1;
    p->gnwin[0] = p->n_win;
    p->gndir[0] = p->n_rows;
    p->glive[0] = static_cast<int32_t>(live_at);
    if (live_at >= 0 && p->n_rows > 0)     // the slots fill the stage
      p->live_slot = static_cast<int32_t>((p->stage_words - live_at)
                                          / p->n_rows);
    for (int e = 0; e < p->n_rows; ++e) p->dlive[e] = e;
  }
  // a slot holds a tile's slice, up to (tile + 62) / 32 words, at its
  // 16-byte phase, in whole 16-byte units
  if (p->live_slot < 0 || (p->live_slot & 3)
      || (p->live_slot > 0 && p->live_slot < (p->tile + 62) / 32 + 3))
    return false;
  p->src_words = (slots > 0 ? slots : 1) * w * n;
  for (int k = 0; k < p->n_win; ++k) {
    p->lo[k] = win[kWinWords * k];
    p->span[k] = static_cast<int32_t>(win[kWinWords * k + 1]);
    p->wrap[k] = static_cast<int32_t>(win[kWinWords * k + 2]);
    p->at[k] = static_cast<int32_t>(win[kWinWords * k + 3]);
    if ((p->at[k] & 3) || p->at[k] < 0 || p->span[k] < 0   // bulk copies
        || p->at[k] + p->span[k] + p->tile + 3 > p->stage_words)  // land
      return false;                                       // 16-byte aligned
  }
  for (int e = 0; e < p->n_rows; ++e) {
    const int k = static_cast<int>(dir[kDirWords * e]);
    if (k < 0 || k >= p->n_win) return false;
    p->dlo[e] = p->lo[k];
    p->dwrap[e] = p->wrap[k];
    p->dat[e] = p->at[k];
    p->ddelta[e] = static_cast<int32_t>(dir[kDirWords * e + 1]);
    p->dmask[e] = static_cast<int32_t>(dir[kDirWords * e + 2]);
  }
  int most = 0;
  for (int g = 0; g < p->n_groups; ++g) {
    const int w0 = p->gwin[g], nwin = p->gnwin[g], d0 = p->gdir[g],
              nd = p->gndir[g];
    if (w0 < 0 || nwin < 0 || nwin > kMaxDirs || w0 + nwin > p->n_win
        || d0 < 0 || nd < 0 || nd > kMaxDirs || d0 + nd > p->n_rows
        || (p->glive[g] >= 0
            && ((p->glive[g] & 3)
                || p->glive[g] + nd * p->live_slot > p->stage_words)))
      return false;
    for (int e = d0; e < d0 + nd; ++e) {   // a group's windows are staged
      const int k = static_cast<int>(dir[kDirWords * e]);  // together
      if (k < w0 || k >= w0 + nwin) return false;
    }
    most = nd > most ? nd : most;
  }
  p->n_dirs = 0;
  if (most > 0) {
    p->n_dirs = 1;
    while (p->n_dirs < most) p->n_dirs *= 2;
  }
  return static_cast<int64_t>(p->stages) * p->stage_words * 4
         <= kMaxSmemBytes;
}

// Blocks per SM of one kernel at one shared-memory size, cached per
// device and kernel (a table's plan is the same every round).
cudaError_t grid_size(const void* kernel, int64_t tiles, size_t smem,
                      int* blocks) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int per_sm, sms;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Entry* hit = nullptr;
  for (int e = 0; e < used && e < 64; ++e)
    if (cache[e].kernel == kernel && cache[e].dev == dev
        && cache[e].smem == smem)
      hit = &cache[e];
  if (hit == nullptr) {
    Entry e{kernel, dev, smem, 0, 0};
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&e.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&e.per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    if (e.per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[used % 64] = e;
    hit = &cache[used % 64];
    ++used;
  }
  const int64_t most = static_cast<int64_t>(hit->sms) * hit->per_sm;
  *blocks = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
}

template <int N, bool kMasked, bool kFused, bool kLive, bool kRing>
int launch_n(const void* src, void* received, void* out, const void* live,
             int64_t w, int64_t n, const Plan& p, cudaStream_t stream) {
  const auto kernel = shift_tiles_kernel<N, kMasked, kFused, kLive, kRing>;
  const size_t smem = static_cast<size_t>(p.stages) * p.stage_words * 4;
  int blocks = 0;
  const cudaError_t err =
      grid_size(reinterpret_cast<const void*>(kernel),
                w * ((n + p.tile - 1) / p.tile), smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(received),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(live), w, n,
      p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMasked, bool kFused, bool kLive, bool kRing>
int launch_masked(const void* src, void* received, void* out,
                  const void* live, int64_t w, int64_t n, const Plan& p,
                  cudaStream_t stream) {
  switch (p.n_dirs) {
    case 0:
    case 1:
      return launch_n<1, kMasked, kFused, kLive, kRing>(src, received, out,
                                                        live, w, n, p, stream);
    case 2:
      return launch_n<2, kMasked, kFused, kLive, kRing>(src, received, out,
                                                        live, w, n, p, stream);
    case 4:
      return launch_n<4, kMasked, kFused, kLive, kRing>(src, received, out,
                                                        live, w, n, p, stream);
    case 8:
      return launch_n<8, kMasked, kFused, kLive, kRing>(src, received, out,
                                                        live, w, n, p, stream);
    default:
      return launch_n<16, kMasked, kFused, kLive, kRing>(src, received, out,
                                                         live, w, n, p,
                                                         stream);
  }
}

// kLive only without kFused, and kRing (a ring plan, `slots` > 0) only for
// the exchange: the modes the entry points take.
template <bool kFused, bool kLive, bool kRing>
int launch(const void* src, void* received, void* out, const void* live,
           int64_t w, int64_t n, const int64_t* plan, int plan_len,
           void* stream, int64_t slots = 0) {
  static_assert(!(kFused && kLive), "the fused round takes no liveness");
  static_assert(!(kFused && kRing), "the fused round reads one source");
  Plan p;
  if (!unpack(plan, plan_len, w, n, kRing ? slots : 0, &p) || p.tile > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kFused && p.rec_at < 0) || (!kRing && p.n_groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // with liveness, every group with directions stages their slices
  for (int g = 0; kLive && g < p.n_groups; ++g)
    if (p.gndir[g] > 0 && (p.glive[g] < 0 || p.live_slot == 0))
      return static_cast<int>(cudaErrorInvalidValue);
  bool masked = false;
  for (int e = 0; e < p.n_rows; ++e) masked = masked || p.dmask[e] != 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return masked ? launch_masked<true, kFused, kLive, kRing>(
                      src, received, out, live, w, n, p, s)
                : launch_masked<false, kFused, kLive, kRing>(
                      src, received, out, live, w, n, p, s);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan it cannot take) so that a refused
// launch reaches the caller.  The caller guarantees w, n >= 1, device
// pointers to contiguous (w, n) int32 buffers, 4-byte aligned, and a
// host pointer to the `plan_len` words of kernels._shift_plan.

extern "C" int gg_shift_exchange(const void* payload, void* inbox, int64_t w,
                                 int64_t n, const int64_t* plan,
                                 int plan_len, void* stream) {
  return launch<false, false, false>(payload, nullptr, inbox, nullptr, w, n,
                                     plan, plan_len, stream);
}

// live: (directions, ceil(n / 32)) packed liveness rows, int32 words (not
// read when the table has no direction).
extern "C" int gg_shift_masked_exchange(const void* payload, const void* live,
                                        void* inbox, int64_t w, int64_t n,
                                        const int64_t* plan, int plan_len,
                                        void* stream) {
  return launch<false, true, false>(payload, nullptr, inbox, live, w, n,
                                    plan, plan_len, stream);
}

extern "C" int gg_shift_flood_round(void* received, const void* frontier,
                                    void* frontier_next, int64_t w,
                                    int64_t n, const int64_t* plan,
                                    int plan_len, void* stream) {
  return launch<true, false, false>(frontier, received, frontier_next,
                                    nullptr, w, n, plan, plan_len, stream);
}

// The ring mode of the exchange: `ring` is (slots, w, n), and each group
// of the plan (kernels._shift_plan of a table with ring slots) stages its
// windows from its own slot; `live` as in gg_shift_masked_exchange (a row
// a table row), or null for none (the plan then stages no liveness
// slice).
extern "C" int gg_shift_ring_exchange(const void* ring, const void* live,
                                      void* inbox, int64_t slots, int64_t w,
                                      int64_t n, const int64_t* plan,
                                      int plan_len, void* stream) {
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (live == nullptr)
    return launch<false, false, true>(ring, nullptr, inbox, nullptr, w, n,
                                      plan, plan_len, stream, slots);
  return launch<false, true, true>(ring, nullptr, inbox, live, w, n, plan,
                                   plan_len, stream, slots);
}
