// Hand-written Hopper (sm_90a) kernels of the txn-rw-register round (Gossip
// Glomers challenge 6): the wound-or-die claim of each key and the commit of
// the transactions that hold every key they claimed.  A round is these two
// launches between a handful of PyTorch ops (the arrivals before them, the
// version CAS of the requests after them) and no host sync.
//
// Per node i: its open slot c = clamp(cur[i], 0, T - 1), its keys
// keys[i, c, 0..O), its first-attempt round issue' = t where it is active
// and issue[i] < 0 (a fresh transaction), issue[i] else, and its priority
// prio = issue' * N + i, formed in uint32 and read as int32 (the reference's
// int32 product wraps; signed overflow is undefined in C++).
//
// - txn_claim: every active node puts atomicMin(best[k], prio) for each of
//   its keys into best, which the wrapper fills with INT32_MAX (no claim);
//   an inactive node claims nothing, whatever its priority (issue = -1
//   gives a negative one).  The warp's active nodes are counted by a
//   ballot and added, once a warp, into attempts[0] (the charge-at-send
//   ledger's attempts).
//   Replaces: gossip_glomers_tpu/tpu_sim/txn.py _round :264-279, XLA code:
//   the open slot's keys, the priority, the claim and the per-key
//   .at[].min into (K,).
// - txn_commit: a node wins iff it is active and best[k] == prio for every
//   key of its slot.  It reads each key's (value, version) from the store's
//   (N, cap) rows at (owner[k], slot[k]) (the reference's view is a
//   scatter-add of every occupied slot; each key occupies exactly one, so
//   the two agree on every layout kvstore.make_layout builds).  A winner's
//   write ops add (1, value, version read) into the (3, K) requests by
//   atomicAdd, which the wrapper zeroes first: the reference's write
//   requests are scatter-adds, and with a non-power-of-two N two nodes can
//   share a wrapped priority, so two "winners" can share a key; adding keeps
//   the kernel equal to the reference on that input too.  A winner's slot
//   records op_ver / op_val (version + 1 and the written value for a write,
//   the version and value read for a read) and commit_round = t; a first
//   attempt stamps issue_round[i, c] = t; then cur[i] += win and issue[i] =
//   win ? -1 : issue'.  Losers write no record (the reference's mode="drop"
//   at index T).  Each thread reads and writes only its own node's
//   counters and records, so the in-place update races with nothing.
//   Replaces: txn.py _round :280-322, XLA code: the winner test, the
//   (value, version) view, the three write-request scatter-adds, the slot
//   records and the counters.
//
// Keys must lie in [0, K): the kernels skip a key outside it (no claim, no
// win, no request), where the plain version's indexing raises.
//
// Block forms (a mesh rank's block of the node axis): both kernels take
// row0, the global id of local row 0, and n_total, the sim's N, so that a
// local node i claims at iss * n_total + row0 + i, the priority the whole
// problem gives it (the local row count as the multiplier would give every
// rank the same priorities, and the minimum across ranks would pick the
// wrong winners).  best and attempts are then the rank's partials, which
// the caller reduces by a minimum and a sum.  txn_commit reads the best
// that minimum made, and in its view mode reads each key's (value,
// version) from view, the (2, K) all-reduced view of every rank's store
// rows (a key's owner may sit on another rank, so the local rows do not
// hold it); its req is the rank's partial, summed across ranks, as the
// single-device kernel's atomicAdd sums two winners that share a wrapped
// priority.  cur, issue, the records and the stamps are the rank's own.
//
// Bound on the card.  Both passes are bytes-bound and touch most of their
// bytes at random: per active node and key, the claim is one 4-byte atomic
// into a random 32-byte sector of best (in the L2: best is 64 KB at 16,384
// keys); the commit reads best, owner, slot and the (value, version) pair
// at random, and a winner's write op adds three atomics.  Their
// sequential bytes (cur, issue, active, the open slot's keys, the records
// at the open slot) are a few bytes a node.  Design: one thread a node,
// looping over its O keys (O is 1-8 in the workload's configurations), 256
// threads a block; the claim's atomics go straight to the L2; nothing is
// staged, since a node's keys land on unrelated sectors.  Hazard: a hot
// key serializes its claimants' atomics (the workload draws keys
// uniformly, so at 16,384 keys and 65,536 nodes x O = 2 a key sees about
// 8 claims a round).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Node {
  int64_t i;      // local row
  int64_t c;      // open slot, clamped into [0, T)
  int32_t iss;    // issue' (t for a first attempt)
  int32_t prio;   // iss * n_total + row0 + i mod 2^32, as int32
  bool active;
  bool first;     // active and issue < 0
};

__device__ __forceinline__ Node node_of(int64_t i, const int32_t* cur,
                                        const int32_t* issue,
                                        const uint8_t* active,
                                        int64_t n_total, int64_t row0,
                                        int64_t t_dim, int64_t t) {
  Node nd;
  nd.i = i;
  int64_t c = cur[i];
  c = c < 0 ? 0 : (c >= t_dim ? t_dim - 1 : c);
  nd.c = c;
  nd.active = active[i] != 0;
  const int32_t old = issue[i];
  nd.first = nd.active && old < 0;
  nd.iss = nd.first ? static_cast<int32_t>(t) : old;
  const uint32_t p =
      static_cast<uint32_t>(nd.iss) * static_cast<uint32_t>(n_total)
      + static_cast<uint32_t>(row0 + i);
  nd.prio = static_cast<int32_t>(p);
  return nd;
}

__global__ void __launch_bounds__(kThreads)
txn_claim_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ cur,
                 const int32_t* __restrict__ issue,
                 const uint8_t* __restrict__ active,
                 int32_t* __restrict__ best, int32_t* __restrict__ attempts,
                 int64_t n, int64_t t_dim, int64_t o, int64_t k_dim,
                 int64_t t, int64_t row0, int64_t n_total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                    + threadIdx.x;
  bool act = false;
  if (i < n) {
    const Node nd = node_of(i, cur, issue, active, n_total, row0, t_dim, t);
    act = nd.active;
    if (act) {
      const int32_t* kp = keys + (nd.i * t_dim + nd.c) * o;
      for (int64_t j = 0; j < o; ++j) {
        const int32_t k = kp[j];
        if (k >= 0 && k < k_dim) atomicMin(best + k, nd.prio);
      }
    }
  }
  // every lane of the block reaches the ballot (a block never returns
  // early), those past n with act = false
  const unsigned m = __ballot_sync(0xffffffffu, act);
  if ((threadIdx.x & 31) == 0 && m)
    atomicAdd(attempts, static_cast<int32_t>(__popc(m)));
}

__global__ void __launch_bounds__(kThreads)
txn_commit_kernel(const int32_t* __restrict__ best,
                  const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ write,
                  const int32_t* __restrict__ wval, int32_t* cur,
                  int32_t* issue, const uint8_t* __restrict__ active,
                  const int64_t* __restrict__ owner,
                  const int64_t* __restrict__ slot,
                  const int32_t* __restrict__ vals,
                  const int32_t* __restrict__ vers,
                  const int32_t* __restrict__ view,
                  int32_t* __restrict__ op_ver, int32_t* __restrict__ op_val,
                  int32_t* __restrict__ commit_round,
                  int32_t* __restrict__ issue_round,
                  int32_t* __restrict__ req, int64_t n, int64_t t_dim,
                  int64_t o, int64_t k_dim, int64_t cap, int64_t t,
                  int64_t row0, int64_t n_total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                    + threadIdx.x;
  if (i >= n) return;
  const Node nd = node_of(i, cur, issue, active, n_total, row0, t_dim, t);
  const int64_t base = (nd.i * t_dim + nd.c) * o;
  bool win = nd.active;
  for (int64_t j = 0; win && j < o; ++j) {
    const int32_t k = keys[base + j];
    win = k >= 0 && k < k_dim && best[k] == nd.prio;
  }
  if (win) {
    for (int64_t j = 0; j < o; ++j) {
      const int32_t k = keys[base + j];
      int32_t rd_val, rd_ver;
      if (view) {
        rd_val = view[k];
        rd_ver = view[k_dim + k];
      } else {
        const int64_t at = owner[k] * cap + slot[k];
        rd_val = vals[at];
        rd_ver = vers[at];
      }
      if (write[base + j]) {
        const int32_t wv = wval[base + j];
        atomicAdd(req + k, 1);
        atomicAdd(req + k_dim + k, wv);
        atomicAdd(req + 2 * k_dim + k, rd_ver);
        op_ver[base + j] = static_cast<int32_t>(
            static_cast<uint32_t>(rd_ver) + 1u);
        op_val[base + j] = wv;
      } else {
        op_ver[base + j] = rd_ver;
        op_val[base + j] = rd_val;
      }
    }
    commit_round[nd.i * t_dim + nd.c] = static_cast<int32_t>(t);
  }
  if (nd.first) issue_round[nd.i * t_dim + nd.c] = static_cast<int32_t>(t);
  cur[i] = cur[i] + (win ? 1 : 0);
  issue[i] = win ? -1 : nd.iss;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool bad_shape(int64_t n, int64_t t_dim, int64_t o, int64_t k_dim,
               int64_t row0, int64_t n_total) {
  return n < 0 || n > 0x7fffffff || t_dim < 1 || o < 0 || k_dim < 0
         || ceil_div(n, kThreads) > 0x7fffffff || row0 < 0
         || row0 + n > n_total || n_total > 0x7fffffff;
}

}  // namespace

// best[k] = min over the active nodes i claiming k of their priority
// (best filled with INT32_MAX by the caller); attempts[0] += the active
// nodes (zeroed by the caller).  The rows are global rows row0 .. row0 + n
// of n_total (0 and n for the whole problem).
extern "C" int gg_txn_claim(const void* keys, const void* cur,
                            const void* issue, const void* active, void* best,
                            void* attempts, int64_t n, int64_t t_dim,
                            int64_t o, int64_t k_dim, int64_t t, int64_t row0,
                            int64_t n_total, void* stream) {
  if (bad_shape(n, t_dim, o, k_dim, row0, n_total))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  txn_claim_kernel<<<static_cast<unsigned>(ceil_div(n, kThreads)), kThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(cur),
      static_cast<const int32_t*>(issue), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(best), static_cast<int32_t*>(attempts), n, t_dim,
      o, k_dim, t, row0, n_total);
  return static_cast<int>(cudaGetLastError());
}

// The winners' reads, records and (3, K) write requests (req zeroed by the
// caller), and cur / issue, in place.  view: null to read the store's rows
// at (owner, slot), else the (2, K) view (values row 0, versions row 1).
extern "C" int gg_txn_commit(const void* best, const void* keys,
                             const void* write, const void* wval, void* cur,
                             void* issue, const void* active,
                             const void* owner, const void* slot,
                             const void* vals, const void* vers,
                             const void* view, void* op_ver, void* op_val,
                             void* commit_round, void* issue_round, void* req,
                             int64_t n, int64_t t_dim, int64_t o,
                             int64_t k_dim, int64_t cap, int64_t t,
                             int64_t row0, int64_t n_total, void* stream) {
  if (bad_shape(n, t_dim, o, k_dim, row0, n_total) || cap < 0
      || (!view && (!owner || !slot || !vals || !vers)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  txn_commit_kernel<<<static_cast<unsigned>(ceil_div(n, kThreads)), kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(best), static_cast<const int32_t*>(keys),
      static_cast<const uint8_t*>(write), static_cast<const int32_t*>(wval),
      static_cast<int32_t*>(cur), static_cast<int32_t*>(issue),
      static_cast<const uint8_t*>(active),
      static_cast<const int64_t*>(owner), static_cast<const int64_t*>(slot),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(vers),
      static_cast<const int32_t*>(view), static_cast<int32_t*>(op_ver),
      static_cast<int32_t*>(op_val), static_cast<int32_t*>(commit_round),
      static_cast<int32_t*>(issue_round), static_cast<int32_t*>(req), n,
      t_dim, o, k_dim, cap, t, row0, n_total);
  return static_cast<int>(cudaGetLastError());
}
