// Hand-written Hopper (sm_90a) kernels of the g-counter's round (Gossip
// Glomers challenge 4): one read pass that finalizes the round's scalars
// on the card, and one update pass.  A round is these two launches and no
// host sync.
//
// Per node row i, after its gate byte (BLOCKED: the node cannot reach the
// KV this round; WIPE: its pending and cached read 0, the amnesia of a
// restart), want = pending > 0 && reach.
//
// - counter_select: the read pass over pending, cached and the gate.
//   cas mode: the winner is the least (priority, row) among the rows that
//   want and read fresh (cached == kv0), reduced as ONE unsigned 64-bit
//   key (priority << 32 | row): the packed layout's priority is the top
//   31 - row_bits bits of the row's hash capped at all-ones less one, the
//   wide layout's min(hash, 2^32 - 2), and in both the lexicographic
//   minimum is the reference's winner (its packed int32 key minimum, its
//   two-pmin wide argmin).  allreduce mode: the sum of the wanting rows'
//   pending, wrapping as int32 sums do.  Both: the count of want, and on a
//   poll round the polled rows that did not win (cas: reach less the
//   winner; allreduce: reach && !want).  The last block to finish (a
//   threadfence and an arrival counter) writes the new kv (kv0 +
//   pending[winner] or kv0 + the sum), the new msgs ((msgs + 4 want + 2
//   polled) mod 2^32) and the winner row (n: none), and resets the
//   counters for the next round.  It reads pending[winner] before the
//   update pass zeroes it.
//   The partial form (a template flag of the same body, for a rank's block
//   of a mesh): the rows are global rows row0 + i (the hash and the key
//   take them), and the last block writes the block's partial into three
//   int64 words instead of finalizing: the least key XOR 2^63 (signed
//   order, all ones less 2^63 for none), cas: the pending of that key's
//   row (0 for none) / allreduce: the sum, and 4 want + 2 polled with
//   polled cas: reach on a poll round (the global winner's poll is taken
//   off by the finish, after the mesh's minimum).  The caller reduces them
//   over the ranks (min, then the sums) and finishes kv, msgs and the
//   winner word.
//   Replaces: gossip_glomers_tpu/tpu_sim/counter.py _round (:397-476, the
//   flush and the winner, and :498-499, the poll charge), XLA code: the
//   reach and fresh masks, the hash, one or two global min reductions and
//   up to three sums.
// - counter_apply: the update pass.  Drains pending of the winner row
//   (cas) or of every wanting row (allreduce), and sets cached to the new
//   kv where the row wanted, won or was polled, unless the seq-kv stale
//   coin keeps a behind, non-winning reader's old value (stale_num > 0:
//   mix32(i * 0xC2B2AE35 ^ t * 0x9E3779B9 ^ seed ^ salt) < stale_num).  On
//   a rank's block i is the global row row0 + i, as in the winner word.
//   Replaces: counter.py :483-497 and the pending update of :409 / :474.
//
// The hash: x = i * 0x9E3779B9 + (t + seed) * 0x85EBCA6B; x ^= x >> 16;
// x *= 0x7FEB352D; x ^= x >> 15 (uint32), counter.py :428-433.
//
// Bound on the card.  Both passes are bytes-bound: at 2^24 nodes the cas
// read pass reads 8 bytes a node (pending, cached), 0.040 ms at 3.35 TB/s,
// and
// the update pass reads and writes 8 bytes a node, 0.080 ms; the hash is
// about 12 integer operations a node, 0.012 ms at the card's integer
// rate.  In allreduce mode the read pass needs no cached value and loads
// none: 4 bytes a node.  A gate adds a byte a node to each.  Design: a
// grid-stride loop of 256-thread blocks, at most 8 blocks an SM, four
// nodes a thread an iteration by 16-byte loads (4 bytes of gate) where
// every row pointer is so aligned, a node a thread otherwise; the mode is
// a template parameter of the read pass; the read pass reduces in
// registers, then by warp shuffles, then through shared memory, and
// thread 0 of each block adds one atomic per counter into the work words.
// The per-node work is branch-free apart from the gate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr uint8_t kBlocked = 1, kWipe = 2;
constexpr unsigned long long kNoKey = ~0ull;

// The work words (kernels.counter_work: 4 int64), resting state: key all
// ones, counters 0.  winner is written by the last block of each read pass.
struct Work {
  unsigned long long key;   // least (priority << 32 | row)
  unsigned int want;        // rows that want
  unsigned int total;       // allreduce: sum of their pending, mod 2^32
  unsigned int polled;      // polled rows that did not win (see above)
  unsigned int arrived;     // blocks done
  long long winner;         // the round's winner row, n for none
};
static_assert(sizeof(Work) == 32, "Work is four int64 words");

struct Select {
  const int32_t* pending;
  const int32_t* cached;
  const uint8_t* gate;      // or null: every row reaches, none is wiped
  const int32_t* kv0;
  const long long* msgs;
  Work* work;
  int32_t* kv_out;
  long long* msgs_out;
  long long* part;          // the partial form's three words, or null
  int64_t n;
  uint32_t row0;            // the global row of row 0
  uint32_t round_term;      // (t + seed) * 0x85EBCA6B
  int wide, row_bits, poll;
};

struct Apply {
  const int32_t* pending;
  const int32_t* cached;
  const uint8_t* gate;
  const int32_t* kv;
  const Work* work;
  int32_t* pending_out;     // may be pending (each row its own words)
  int32_t* cached_out;
  int64_t n;
  uint32_t row0;            // the global row of row 0
  int cas, poll;
  uint32_t stale_num, stale_key;
};

__device__ __forceinline__ uint32_t priority(uint32_t row,
                                             const Select& s) {
  uint32_t x = row * 0x9E3779B9u + s.round_term;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  if (s.wide) return min(x, 0xFFFFFFFEu);
  const int pri_bits = 31 - s.row_bits;
  return min(x >> (32 - pri_bits), (1u << pri_bits) - 2u);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Acc {
  unsigned long long key = kNoKey;
  uint32_t want = 0, total = 0, polled = 0;
};

// c: the row's cached value, read in cas mode only
template <bool kCas>
__device__ __forceinline__ void select_row(int64_t i, int32_t p, int32_t c,
                                           uint8_t g, int32_t kv0,
                                           const Select& s, Acc& a) {
  if (g & kWipe) p = c = 0;
  const bool reach = !(g & kBlocked);
  const bool want = p > 0 && reach;
  a.want += want;
  if (kCas) {
    if (want && c == kv0) {
      const uint32_t row = s.row0 + static_cast<uint32_t>(i);
      const unsigned long long key =
          static_cast<unsigned long long>(priority(row, s)) << 32 | row;
      a.key = key < a.key ? key : a.key;
    }
    a.polled += s.poll && reach;
  } else {
    a.total += want ? static_cast<uint32_t>(p) : 0u;
    a.polled += s.poll && reach && !want;
  }
}

template <bool kVec, bool kCas, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    counter_select_kernel(const Select s) {
  const int32_t kv0 = *s.kv0;
  Acc a;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    const int64_t quads = s.n / 4;
    const int4* p4 = reinterpret_cast<const int4*>(s.pending);
    const int4* c4 = reinterpret_cast<const int4*>(s.cached);
    const uchar4* g4 = reinterpret_cast<const uchar4*>(s.gate);
    for (int64_t q = tid; q < quads; q += stride) {
      const int4 p = __ldg(p4 + q);
      const int4 c = kCas ? __ldg(c4 + q) : make_int4(0, 0, 0, 0);
      const uchar4 g = s.gate ? g4[q] : make_uchar4(0, 0, 0, 0);
      select_row<kCas>(4 * q, p.x, c.x, g.x, kv0, s, a);
      select_row<kCas>(4 * q + 1, p.y, c.y, g.y, kv0, s, a);
      select_row<kCas>(4 * q + 2, p.z, c.z, g.z, kv0, s, a);
      select_row<kCas>(4 * q + 3, p.w, c.w, g.w, kv0, s, a);
    }
    tail = quads * 4;
  }
  for (int64_t i = tail + tid; i < s.n; i += stride)
    select_row<kCas>(i, __ldg(s.pending + i),
                     kCas ? __ldg(s.cached + i) : 0,
                     s.gate ? s.gate[i] : uint8_t{0}, kv0, s, a);

  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long k = __shfl_xor_sync(0xFFFFFFFFu, a.key, o);
    a.key = k < a.key ? k : a.key;
    a.want += __shfl_xor_sync(0xFFFFFFFFu, a.want, o);
    a.total += __shfl_xor_sync(0xFFFFFFFFu, a.total, o);
    a.polled += __shfl_xor_sync(0xFFFFFFFFu, a.polled, o);
  }
  __shared__ unsigned long long keys[kWarps];
  __shared__ uint32_t wants[kWarps], totals[kWarps], polls[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    keys[warp] = a.key;
    wants[warp] = a.want;
    totals[warp] = a.total;
    polls[warp] = a.polled;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    a.key = keys[w] < a.key ? keys[w] : a.key;
    a.want += wants[w];
    a.total += totals[w];
    a.polled += polls[w];
  }
  Work* work = s.work;
  if (a.key != kNoKey) atomicMin(&work->key, a.key);
  if (a.want) atomicAdd(&work->want, a.want);
  if (a.total) atomicAdd(&work->total, a.total);
  if (a.polled) atomicAdd(&work->polled, a.polled);
  __threadfence();
  if (atomicAdd(&work->arrived, 1u) != gridDim.x - 1) return;

  // the last block: every other block's atomics are done; read each
  // counter and reset it in one exchange
  __threadfence();
  const unsigned long long key = atomicExch(&work->key, kNoKey);
  const uint32_t want = atomicExch(&work->want, 0u);
  const uint32_t total = atomicExch(&work->total, 0u);
  uint32_t polled = atomicExch(&work->polled, 0u);
  atomicExch(&work->arrived, 0u);
  if (kPartial) {
    long long delta = 0;
    if (kCas && key != kNoKey)
      delta = s.pending[static_cast<uint32_t>(key) - s.row0];
    else if (!kCas)
      delta = static_cast<long long>(total);
    s.part[0] = static_cast<long long>(key ^ (1ull << 63));
    s.part[1] = delta;
    s.part[2] = static_cast<long long>(4ull * want + 2ull * polled);
    return;
  }
  uint32_t kv = static_cast<uint32_t>(kv0);
  long long winner = s.n;
  if (kCas) {
    if (key != kNoKey) {
      winner = static_cast<long long>(key & 0xFFFFFFFFull);
      kv += static_cast<uint32_t>(s.pending[winner]);
      polled -= s.poll ? 1u : 0u;     // the winner reaches: it was polled
    }
  } else {
    kv += total;
  }
  work->winner = winner;
  *s.kv_out = static_cast<int32_t>(kv);
  *s.msgs_out = static_cast<long long>(
      (static_cast<unsigned long long>(*s.msgs) + 4ull * want
       + 2ull * polled) & 0xFFFFFFFFull);
}

__device__ __forceinline__ void apply_row(int64_t i, int32_t p, int32_t c,
                                          uint8_t g, int32_t kv,
                                          long long winner, const Apply& s,
                                          int32_t& p_out, int32_t& c_out) {
  if (g & kWipe) p = c = 0;
  const bool reach = !(g & kBlocked);
  const bool want = p > 0 && reach;
  const uint32_t row = s.row0 + static_cast<uint32_t>(i);
  const bool won = s.cas ? row == winner : want;
  int32_t val = kv;
  if (s.stale_num && !won && c != kv
      && mix32(row * 0xC2B2AE35u ^ s.stale_key) < s.stale_num)
    val = c;
  p_out = won ? 0 : p;
  c_out = want || won || (s.poll && reach) ? val : c;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    counter_apply_kernel(const Apply s) {
  const int32_t kv = *s.kv;
  const long long winner = s.work->winner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    const int64_t quads = s.n / 4;
    const int4* p4 = reinterpret_cast<const int4*>(s.pending);
    const int4* c4 = reinterpret_cast<const int4*>(s.cached);
    const uchar4* g4 = reinterpret_cast<const uchar4*>(s.gate);
    int4* po = reinterpret_cast<int4*>(s.pending_out);
    int4* co = reinterpret_cast<int4*>(s.cached_out);
    for (int64_t q = tid; q < quads; q += stride) {
      const int4 p = p4[q], c = c4[q];
      const uchar4 g = s.gate ? g4[q] : make_uchar4(0, 0, 0, 0);
      int4 pn, cn;
      apply_row(4 * q, p.x, c.x, g.x, kv, winner, s, pn.x, cn.x);
      apply_row(4 * q + 1, p.y, c.y, g.y, kv, winner, s, pn.y, cn.y);
      apply_row(4 * q + 2, p.z, c.z, g.z, kv, winner, s, pn.z, cn.z);
      apply_row(4 * q + 3, p.w, c.w, g.w, kv, winner, s, pn.w, cn.w);
      po[q] = pn;
      co[q] = cn;
    }
    tail = quads * 4;
  }
  for (int64_t i = tail + tid; i < s.n; i += stride)
    apply_row(i, s.pending[i], s.cached[i], s.gate ? s.gate[i] : uint8_t{0},
              kv, winner, s, s.pending_out[i], s.cached_out[i]);
}

bool aligned_rows(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <bool kPartial>
void launch_select(const Select& s, bool vec, bool cas, unsigned blocks,
                   cudaStream_t st) {
  if (vec && cas)
    counter_select_kernel<true, true, kPartial><<<blocks, kThreads, 0, st>>>(
        s);
  else if (vec)
    counter_select_kernel<true, false, kPartial>
        <<<blocks, kThreads, 0, st>>>(s);
  else if (cas)
    counter_select_kernel<false, true, kPartial>
        <<<blocks, kThreads, 0, st>>>(s);
  else
    counter_select_kernel<false, false, kPartial>
        <<<blocks, kThreads, 0, st>>>(s);
}

unsigned blocks_for(int64_t units) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (units + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an argument it cannot take).  The caller
// guarantees device pointers to contiguous buffers: (n,) int32 pending,
// cached and outputs, (n,) bytes gate or null, 0-dim int32 kv0 / kv and
// int64 msgs / msgs_out, and the four int64 work words in their resting
// state (kernels.counter_work), which the read pass leaves so.  row0: the
// global row of row 0 (0 off a mesh), row0 + n < 2^31.  part: null for the
// full read pass, else three int64 words for the partial form (kv_out,
// msgs_out and the winner word are then not written).

extern "C" int gg_counter_select(const void* pending, const void* cached,
                                 const void* gate, const void* kv0,
                                 const void* msgs, void* work, void* kv_out,
                                 void* msgs_out, void* part, int64_t n,
                                 int64_t row0, int64_t ts, int cas, int wide,
                                 int row_bits, int poll, void* stream) {
  if (n < 0 || row0 < 0 || n + row0 >= (int64_t{1} << 31)
      || (cas && !wide && (row_bits < 1 || row_bits > 23)))
    return static_cast<int>(cudaErrorInvalidValue);
  Select s;
  s.pending = static_cast<const int32_t*>(pending);
  s.cached = static_cast<const int32_t*>(cached);
  s.gate = static_cast<const uint8_t*>(gate);
  s.kv0 = static_cast<const int32_t*>(kv0);
  s.msgs = static_cast<const long long*>(msgs);
  s.work = static_cast<Work*>(work);
  s.kv_out = static_cast<int32_t*>(kv_out);
  s.msgs_out = static_cast<long long*>(msgs_out);
  s.part = static_cast<long long*>(part);
  s.n = n;
  s.row0 = static_cast<uint32_t>(row0);
  s.round_term = static_cast<uint32_t>(ts) * 0x85EBCA6Bu;
  s.wide = wide;
  s.row_bits = row_bits;
  s.poll = poll;
  const bool vec = aligned_rows(pending, 16)
                   && (!cas || aligned_rows(cached, 16))
                   && (gate == nullptr || aligned_rows(gate, 4));
  const unsigned blocks = blocks_for(vec ? (n + 3) / 4 : n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (part != nullptr)
    launch_select<true>(s, vec, cas != 0, blocks, st);
  else
    launch_select<false>(s, vec, cas != 0, blocks, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gg_counter_apply(const void* pending, const void* cached,
                                const void* gate, const void* kv,
                                const void* work, void* pending_out,
                                void* cached_out, int64_t n, int64_t row0,
                                int cas, int poll, int64_t stale_num,
                                int64_t stale_key, void* stream) {
  if (n < 0 || row0 < 0 || n + row0 >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  Apply s;
  s.pending = static_cast<const int32_t*>(pending);
  s.cached = static_cast<const int32_t*>(cached);
  s.gate = static_cast<const uint8_t*>(gate);
  s.kv = static_cast<const int32_t*>(kv);
  s.work = static_cast<const Work*>(work);
  s.pending_out = static_cast<int32_t*>(pending_out);
  s.cached_out = static_cast<int32_t*>(cached_out);
  s.n = n;
  s.row0 = static_cast<uint32_t>(row0);
  s.cas = cas;
  s.poll = poll;
  s.stale_num = static_cast<uint32_t>(stale_num);
  s.stale_key = static_cast<uint32_t>(stale_key);
  const bool vec = aligned_rows(pending, 16) && aligned_rows(cached, 16)
                   && aligned_rows(pending_out, 16)
                   && aligned_rows(cached_out, 16)
                   && (gate == nullptr || aligned_rows(gate, 4));
  const unsigned blocks = blocks_for(vec ? (n + 3) / 4 : n);
  if (vec)
    counter_apply_kernel<true><<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(s);
  else
    counter_apply_kernel<false><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}
