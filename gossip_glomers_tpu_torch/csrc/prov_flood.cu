// Hand-written Hopper (sm_90a) kernel of the causal provenance record of
// the node-major gather round: for each bit that a round newly delivered,
// the round it arrived (arrival = t + 1) and the neighbour whose delivery
// carried it first (parent).
//
// - prov_attribute: per destination node i and word c of the round's new
//   bits, walk the directions d = 0 .. D-1 in order and form direction d's
//   delivered word, the term the round's inbox ORed:
//     flag mode  (one hop): src[nbrs[i, d]] where the edge's flag byte has
//                DEL (kernels.FLAG_DEL; no flag bytes: every index >= 0
//                delivers), ORed with dup[nbrs[i, d]] where it has DUP;
//     slot mode  (per-edge delays): the word of the edge's ring slot,
//                src[slot][nbrs[i, d]], where the slot byte is >= 0 (the
//                caller folds the send round's coins and the receiver's
//                liveness into it; -1: nothing delivered);
//   then hit = term & remaining, remaining &= ~hit, and for every bit b of
//   hit with v = 32 c + b < V and arrival[i, v] < 0, parent[i, v] =
//   nbrs[i, d]; last, arrival[i, v] = t + 1 for every such bit of new.
//   A padded direction (nbrs = -1) delivers nothing but keeps its place in
//   the order; indices are clipped into the source rows before the mask
//   applies, as the reference clips them.  Stamps are first-incarnation: a
//   cell already stamped (>= 0) is never written.
//   Replaces: no Pallas kernel.  The XLA code of
//   gossip_glomers_tpu/tpu_sim/broadcast.py _prov_attribute (:317-342) and
//   its term functions (:586-642): D unpacks of (N, V) bools and D selects
//   of (N, V) int32.
//
// Bound on the card.  The function reads the new words (4 N W bytes) and,
// for each word with a fresh bit, the node's table entries and flag or slot
// bytes (5 D bytes) and up to D source words, one random 32-byte sector
// each; it reads the arrival cell of each new bit and writes the two stamps
// of each fresh one.  At the 2^20-node tree (D = 5, W = 1) the random
// sector reads bound it, like the gather kernels (gather_flood.cu).
// Design: one thread a (node, word), so that the stamps of a word are one
// thread's and need no atomics; a word with no new bit returns after one
// load, and the direction walk stops once every new bit is attributed.
// The simple form first: a warp's stamp writes land in 32 rows (stride 4 V
// bytes), not coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kFlagDel = 2;   // kernels.FLAG_DEL
constexpr uint8_t kFlagDup = 4;   // kernels.FLAG_DUP

struct Args {
  const uint32_t* fresh_new;  // (n, w) the round's new bits
  const uint32_t* src;        // (n_src, w), or (slots, n_src, w)
  const uint32_t* dup;        // (n_src, w) or null (flag mode)
  const int32_t* nbrs;        // (n, d)
  const uint8_t* edge;        // (n, d) flag or slot bytes, or null
  int32_t* arrival;           // (n, v)
  int32_t* parent;            // (n, v)
  int64_t n, w, n_src, v, slot_words;
  int d;
  int slot_mode;
  int32_t t_next;
};

__global__ void __launch_bounds__(kThreads) prov_attribute_kernel(Args a) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (idx >= a.n * a.w) return;
  const int64_t i = idx / a.w, c = idx - i * a.w;
  const uint32_t nw = __ldg(a.fresh_new + idx);
  if (nw == 0) return;
  // the bits of word c that are values (v < V)
  const int64_t v0 = c * 32;
  const int64_t room = a.v - v0;
  const uint32_t in_v = room >= 32 ? ~0u : room <= 0 ? 0u
                        : (1u << room) - 1u;
  int32_t* arr = a.arrival + i * a.v + v0;
  int32_t* par = a.parent + i * a.v + v0;
  uint32_t fresh = 0;
  for (uint32_t m = nw & in_v; m; m &= m - 1) {
    const int b = __ffs(m) - 1;
    if (arr[b] < 0) fresh |= 1u << b;
  }
  if (fresh == 0) return;
  const int32_t* row = a.nbrs + i * a.d;
  const uint8_t* edge = a.edge ? a.edge + i * a.d : nullptr;
  uint32_t remaining = nw;
  for (int d = 0; d < a.d && (remaining & fresh); ++d) {
    const int32_t j = __ldg(row + d);
    const int64_t jc = j < 0 ? 0 : j >= a.n_src ? a.n_src - 1 : j;
    uint32_t term = 0;
    if (a.slot_mode) {
      const int8_t s = static_cast<int8_t>(__ldg(edge + d));
      if (s >= 0) term = __ldg(a.src + s * a.slot_words + jc * a.w + c);
    } else {
      const uint8_t f = edge ? __ldg(edge + d) : (j >= 0 ? kFlagDel : 0);
      if (f & kFlagDel) term = __ldg(a.src + jc * a.w + c);
      if ((f & kFlagDup) && a.dup) term |= __ldg(a.dup + jc * a.w + c);
    }
    const uint32_t hit = term & remaining;
    remaining &= ~hit;
    for (uint32_t m = hit & fresh; m; m &= m - 1) par[__ffs(m) - 1] = j;
  }
  for (uint32_t m = fresh; m; m &= m - 1) arr[__ffs(m) - 1] = a.t_next;
}

}  // namespace

// The stamps of one gather round, in place (prov_flood.cu's header).
// slot_mode 0: src is (n_src, w), edge the flag bytes or null, dup the dup
// rows or null; slot_mode 1: src is (slots, n_src, w) with slot_words =
// n_src * w, edge the slot bytes.
extern "C" int gg_prov_attribute(const void* fresh_new, const void* src,
                                 const void* dup, const void* nbrs,
                                 const void* edge, void* arrival,
                                 void* parent, int64_t n, int64_t w,
                                 int64_t n_src, int64_t v, int d,
                                 int64_t slot_words, int slot_mode,
                                 int t_next, void* stream) {
  if (n < 0 || w < 1 || n_src < 1 || v < 0 || v > 32 * w || d < 1
      || (slot_mode && edge == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n * w + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(fresh_new),
         static_cast<const uint32_t*>(src),
         static_cast<const uint32_t*>(dup),
         static_cast<const int32_t*>(nbrs),
         static_cast<const uint8_t*>(edge),
         static_cast<int32_t*>(arrival), static_cast<int32_t*>(parent),
         n, w, n_src, v, slot_words, d, slot_mode,
         static_cast<int32_t>(t_next)};
  prov_attribute_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
