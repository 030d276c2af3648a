"""Broadcast (challenge 3) on PyTorch: the flood simulator.

The port of gossip_glomers_tpu/tpu_sim/broadcast.py's single-device
paths.  Each node keeps a ``received`` bitset and a ``frontier`` bitset
(the values learned last round); one round delivers every node's
frontier to its topology neighbors and keeps what is new:

    new = exchange(frontier) & ~received
    received |= new
    frontier  = new

and every ``sync_every`` rounds the payload is the full received set (the
reference's push-pull anti-entropy).  Two layouts, as in the reference:

- **words-major (W, N)** with a structured exchange (tree, grid, ring,
  line, circulant: :mod:`.structured`) — the main path — under a
  partition schedule (the masked closures of
  :func:`.structured.make_faulted`), the nemesis (the mask bundle of
  :func:`.structured.make_nemesis` with its :class:`.faults.FaultPlan`)
  and per-hop latency (per-direction delay classes,
  :func:`.structured.make_delayed`, and random per-edge delays,
  :func:`.structured.make_edge_delayed`, each also under partitions;
  the nemesis's ``dir_delays``);
- **node-major (N, W)** with the adjacency gather over a padded (N, D)
  neighbor table — any topology, under a partition schedule
  (:class:`Partitions`), a nemesis :class:`.faults.FaultPlan`
  (crash/restart with amnesia, loss, duplicate delivery, membership),
  materialized or streamed over destination slabs (``union_block``), and
  per-edge ``delays``.

A delay mode keeps a ring of the last L payloads in the state
(``history``, L the largest delay): every round pushes its payload into
slot ``t % L``, and an edge or direction of delay v delivers the payload
of round ``t - (v - 1)`` from its slot, with the liveness of that send
round (drops happen at send time, as in Maelstrom).

State: ``received`` and ``frontier`` are int32, bit-identical to the
reference's uint32 words (torch's uint32 lacks ``~``, ``>>`` and
comparisons on the CPU).  The ledgers ``msgs`` and ``srv_msgs`` are ()
int64 tensors holding uint32 values: every add is masked to 32 bits, so
they wrap exactly where the reference's uint32 ledgers wrap.  ``t`` is a
host int: the round schedule (sync waves, the t == 0 ledger coefficient,
which partition windows are active) is host control flow in eager
PyTorch.

The observed driver (:meth:`BroadcastSim.run_observed`) carries the
telemetry ring and, on the gather path, the causal provenance record
(:mod:`.provenance`: each delivered bit's arrival round and the neighbour
that first delivered it, :func:`.kernels.prov_attribute`).

:class:`FoldedBatch` runs S scenarios of one adjacency as one graph of S
N rows, the scenario batches' folded round (:mod:`.scenario`).

On a mesh (``BroadcastSim(mesh=)``, a :class:`..parallel.mesh.Mesh`)
each rank holds its block of the node axis, (W, N/P) words-major or (N/P,
W) node-major, on ``mesh.device``, and the rounds above run unchanged on
it with their closures swapped, as the reference's ``shard_map`` bodies
do: the halo exchanges of :func:`.structured.make_sharded_exchange` (or
the all-gather fallback ``widen`` and ``local_slice`` for shapes with no
halo form), the node-major gather over the all-gathered payload, and the
ledgers' ``reduce_sum`` an all-reduce of each shard's uint32 partial
(int64, then masked to 32 bits: it wraps where the reference's uint32
psum wraps).  Every fault and delay mode runs there too: the partition,
nemesis and delay bundles built with ``n_shards=`` hand their halo
closures, which mask a rank's block with its own packed rows (the
nemesis's mask operand cut by :meth:`.faults.WMNemesisArrays.shard`, its
coins hashing global ids) and deliver from the rank's block of the ring;
the gather path's fault plan hashes the rows' global ids over every
node's liveness, all-gathers the payload and the dup rows, and streams
``union_block`` slabs of the rank's rows; its ``delays`` ring stays
node-sharded, each round all-gathering the slots it reads.  The round
counter and the sync waves stay host ints, and every convergence flag is
agreed over the mesh before any rank branches on it.  The traffic driver
and the observed driver's telemetry ring run on a mesh in both layouts
and every mode above: a rank sets its own clients' value bits at their
home nodes (which lie in its block), an op is visible once
:func:`.kernels.and_fold` over the rank's block, then the engine's
``reduce_and`` over the ranks, holds its bit (no all-gather), and a
round's telemetry row (the popcounts and the tracker's issued count) is
finished by one packed all-reduce.  The observed driver's provenance
record rides the gather path on a mesh too, each rank stamping its own
rows: :func:`.kernels.prov_attribute` reads the round's own all-gathered
payload (and dup rows), or the ring slots the round has already widened,
stacked, so the record adds no collective to a round.

On a mesh with a ``words`` axis (``("nodes", "words")``, or the 1-D
words mesh) a rank holds (W/Pw, N/Pn) words-major or (N/Pn, W/Pw)
node-major: the halo exchanges, the all-gather fallback and the gather
path's all-gather run along ``nodes`` only, every kernel runs on the
rank's block as it is, the ledgers' popcount partials are summed over
both axes, the sync waves' per-node base is charged by word shard 0
alone (:attr:`Shard.base_once`), and the convergence target is the
rank's words of it, agreed over every rank.  Provenance and the traffic
drivers refuse a words mesh, as the reference's do.  On a hierarchical
``("hosts", "nodes")`` mesh the node blocks are the flat mesh's, and
``dcn_mode`` schedules the ledgers' sums over the hosts level
(:func:`.engine.dcn_psum`: ``sync`` or ``pipelined``; ``stale:k``
refuses).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import faults, kernels, provenance, telemetry, traffic
from .engine import (active_windows, fori_rounds, node_index, node_shards,
                     resolve_block, word_index, word_shards,
                     resolve_device, scan_blocks, send_slot,
                     stepwise_converge, while_converge, windows_fold)
from .kernels import FLAG_DEL, FLAG_OUT_OK, FLAG_SEND, MASK32

WORD = 32

def _ident(x):
    return x


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's view of the node axis, which the round functions take in
    one piece; :data:`ONE_DEVICE`, the identity, off a mesh.

    - ``reduce_sum`` globalizes a ledger's shard partial (an all-reduce);
    - ``widen`` maps a local block to the whole node axis (an all-gather:
      the gather path and the words-major all-gather fallback; the halo
      path's closures exchange the halo instead and leave it the
      identity);
    - ``rows``: the block's slice of the node axis where a full-axis
      result must be cut back to it (the all-gather fallback), else None;
    - ``row0``, the block's first global node, and ``all_ids``, every
      node's id: the gather path's fault coins hash global ids over
      every node's liveness;
    - ``base_once``: whether this rank charges the sync waves' per-node
      base (reads and read_oks): on a ``words`` mesh every word shard
      holds the same nodes, so only word shard 0 does, while the
      popcount partials sum over the word shards."""

    reduce_sum: Callable = _ident
    widen: Callable = _ident
    rows: slice | None = None
    row0: int = 0
    all_ids: torch.Tensor | None = None
    base_once: bool = True

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """A full-axis (W, N) result's words of this block."""
        return x if self.rows is None else x[:, self.rows].contiguous()

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """A full-axis (..., N) column row's columns of this block."""
        return x if self.rows is None else x[..., self.rows]


ONE_DEVICE = Shard()


def num_words(n_values: int) -> int:
    return max(1, (n_values + WORD - 1) // WORD)


def make_inject(n_nodes: int, n_values: int,
                origins: np.ndarray | None = None) -> np.ndarray:
    """Initial injection bitset: value v starts at node origins[v]
    (default v % n_nodes — the round-robin the workload client uses).
    Returns (N, W) uint32."""
    w = num_words(n_values)
    out = np.zeros((n_nodes, w), dtype=np.uint32)
    if origins is None:
        origins = np.arange(n_values) % n_nodes
    for v in range(n_values):
        out[origins[v], v // WORD] |= np.uint32(1 << (v % WORD))
    return out


def wrap32(x):
    """Reduce an int or an int64 tensor mod 2^32 — uint32 wraparound."""
    return x & MASK32


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a_i * b_i mod 2^32 (each product wrapped first, as the
    reference's uint32 products are), as a () int64 tensor."""
    return wrap32(wrap32(a.to(torch.int64) * b).sum())


@dataclasses.dataclass(frozen=True)
class Partitions:
    """Partition schedule as data: window w is active for rounds
    [starts[w], ends[w]); while active, edges between nodes of different
    ``group[w]`` ids drop.  ``starts`` / ``ends`` are host ints (the
    round counter is one), ``group`` a (P, N) int8 tensor."""

    starts: tuple[int, ...]
    ends: tuple[int, ...]
    group: torch.Tensor

    @staticmethod
    def none(n_nodes: int) -> "Partitions":
        return Partitions((), (), torch.zeros((0, n_nodes),
                                              dtype=torch.int8))

    @staticmethod
    def from_numpy(starts, ends, group) -> "Partitions":
        """From the reference's arrays: (P,) starts and ends, (P, N)
        group ids."""
        group = np.asarray(group, dtype=np.int8)
        starts = tuple(int(v) for v in np.asarray(starts).reshape(-1))
        ends = tuple(int(v) for v in np.asarray(ends).reshape(-1))
        if group.ndim != 2 or not (len(starts) == len(ends)
                                   == group.shape[0]):
            raise ValueError(
                f"Partitions need (P,) starts and ends and a (P, N) group; "
                f"got {len(starts)}, {len(ends)} and {group.shape}")
        return Partitions(starts, ends, torch.from_numpy(group.copy()))

    @property
    def n_windows(self) -> int:
        return len(self.starts)

    def active(self, t: int) -> list[int]:
        return active_windows(self.starts, self.ends, t)

    def to(self, device: str | torch.device) -> "Partitions":
        return dataclasses.replace(self, group=self.group.to(device))

    def to_meta(self) -> dict:
        """JSON-able form (the reference's): the runners and checkers
        carry the schedule as data."""
        return {"starts": list(self.starts), "ends": list(self.ends),
                "group": self.group.cpu().numpy().tolist()}

    @staticmethod
    def from_meta(meta: dict) -> "Partitions":
        group = np.asarray(meta["group"], dtype=np.int8)
        if group.ndim != 2:
            raise ValueError(
                f"Partitions meta group must be (P, N), got shape "
                f"{group.shape}")
        return Partitions.from_numpy(meta["starts"], meta["ends"], group)


@dataclasses.dataclass
class BroadcastState:
    received: torch.Tensor            # (W, N) or (N, W) int32
    frontier: torch.Tensor            # same layout
    t: int                            # round counter
    msgs: torch.Tensor                # () int64, uint32 value-message ledger
    # reference-accounted server-message ledger (() int64 holding a
    # uint32), or None when srv_ledger is off
    srv_msgs: torch.Tensor | None = None
    # delay modes only: the ring of the last L payloads, (L, W, N)
    # words-major or (L, N, W) node-major, slot t % L holding round t's;
    # None when every edge is one hop
    history: torch.Tensor | None = None


def _bits_from_numpy(a: np.ndarray, words_major: bool) -> torch.Tensor:
    """(N, W) uint32 numpy -> a fresh int32 CPU tensor in the layout
    (always a copy: the loops update received in place)."""
    a = np.asarray(a, np.uint32)
    return torch.from_numpy(
        np.array(a.T if words_major else a, order="C").view(np.int32))


def _bits_to_numpy(x: torch.Tensor, words_major: bool) -> np.ndarray:
    """An int32 bitset in the layout -> (N, W) uint32 numpy."""
    a = x.cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(a.T if words_major else a)


def state_from_numpy(received: np.ndarray, frontier: np.ndarray, t: int,
                     msgs: int, srv_msgs: int | None,
                     device: str | torch.device, *,
                     words_major: bool = True,
                     history: np.ndarray | None = None) -> BroadcastState:
    """A port state from the reference's values as numpy: node-major
    (N, W) uint32 bitsets (the JAX words-major arrays transposed) and
    integer ledgers; ``words_major`` picks the port state's layout.
    ``history``: a delay mode's ring as (L, N, W) uint32, each slot laid
    out as ``received`` (the JAX words-major (L, W, N) ring transposed
    slot by slot)."""
    def bits(a: np.ndarray) -> torch.Tensor:
        return _bits_from_numpy(a, words_major).to(device)

    ring = None
    if history is not None:
        ring = torch.stack([bits(h) for h in np.asarray(history, np.uint32)])

    def ledger(v: int) -> torch.Tensor:
        return torch.tensor(int(v) & MASK32, dtype=torch.int64,
                            device=device)

    return BroadcastState(received=bits(received), frontier=bits(frontier),
                          t=int(t), msgs=ledger(msgs),
                          srv_msgs=None if srv_msgs is None
                          else ledger(srv_msgs), history=ring)


def state_to_numpy(state: BroadcastState, *, words_major: bool = True):
    """(received, frontier, t, msgs, srv_msgs) with node-major (N, W)
    uint32 bitsets and int ledgers — the inverse of
    :func:`state_from_numpy` for a state in the given layout; a state
    with a delay ring adds it as a sixth element, (L, N, W) uint32."""
    out = (_bits_to_numpy(state.received, words_major),
           _bits_to_numpy(state.frontier, words_major), state.t,
           int(state.msgs),
           None if state.srv_msgs is None else int(state.srv_msgs))
    if state.history is None:
        return out
    return out + (np.stack([_bits_to_numpy(h, words_major)
                            for h in state.history]),)


def _ring_push(history: torch.Tensor, payload: torch.Tensor,
               t: int) -> torch.Tensor:
    """The ring after round ``t`` pushed its payload: a copy (the state
    it came from keeps its own) with slot ``t % L`` overwritten."""
    ring = history.clone()
    ring[t % ring.shape[0]] = payload
    return ring


# -- the node-major gather path -----------------------------------------


def _edge_live(t: int, row_ids: torch.Tensor, nbrs: torch.Tensor,
               nbr_mask: torch.Tensor, parts: Partitions) -> torch.Tensor:
    """(rows, D) bool — which edges deliver this round (pad edges never,
    partitioned edges not while a window covering them is active).
    ``nbr_mask`` itself when no window is active at ``t``."""
    def body(w: int, live: torch.Tensor) -> torch.Tensor:
        g = parts.group[w]
        src = nbrs.clamp(0, g.shape[0] - 1).to(torch.int64)
        return live & (g[row_ids][:, None] == g[src])

    return windows_fold(parts.starts, parts.ends, t, body, nbr_mask)


def _live_split(t: int, row_ids: torch.Tensor, nbrs: torch.Tensor,
                nbr_mask: torch.Tensor, parts: Partitions,
                plan: faults.FaultPlan | None, dup_on: bool):
    """Per-edge (rows, D) masks at send round ``t`` under the full
    nemesis, the reference's plain composition: ``live_send`` = topology
    & partition windows & both endpoints up (sends charged);
    ``live_del`` = live_send minus the loss coins (deliveries); ``dup`` =
    live_del edges that also re-deliver their source's received set
    (None without ``dup_on``).  The rounds evaluate the same coins as
    one kernel, :func:`.kernels.fault_coins`."""
    live = _edge_live(t, row_ids, nbrs, nbr_mask, parts)
    if plan is None:
        return live, live, None
    src = nbrs.clamp(0, plan.n_nodes - 1).to(torch.int64)
    live_send = (live & faults.node_up(plan, t, row_ids)[:, None]
                 & faults.node_up(plan, t, src))
    live_del = live_send & ~faults.edge_drop(plan, t, src, row_ids[:, None])
    dup = (live_del & faults.edge_dup(plan, t, src, row_ids[:, None])
           if dup_on else None)
    return live_send, live_del, dup


def _gather_or(payload: torch.Tensor, nbrs: torch.Tensor,
               live: torch.Tensor | None) -> torch.Tensor:
    """inbox[i] = OR over delivering edges d of payload[nbrs[i, d]]
    (``live=None``: the edges with ``nbrs >= 0``).  The reference's
    ``_gather_or``: the delay ring's delivery; the one-hop rounds run the
    fused ``gather_flood_round`` / ``faulted_gather_round`` instead."""
    return kernels.gather_or(payload, nbrs, live)


def _up_all(plan: faults.FaultPlan, t: int, row_ids: torch.Tensor,
            all_ids: torch.Tensor | None) -> torch.Tensor:
    """(N,) bool: every node's liveness at round ``t``, which the coins'
    ``up`` operand covers (``all_ids``: every node id on a mesh, whose
    ``row_ids`` are a block; None off a mesh, where they are all)."""
    return faults.node_up(plan, t, row_ids if all_ids is None else all_ids)


def _live_del_at(t: int, row_ids: torch.Tensor, nbrs: torch.Tensor,
                 nbr_mask: torch.Tensor, parts: Partitions,
                 plan: faults.FaultPlan | None, *,
                 shard: Shard = ONE_DEVICE) -> torch.Tensor:
    """(rows, D) bool: the edges that deliver a message sent at round
    ``t``: topology and partition windows, and under a ``plan`` both
    endpoints up and the loss coin kept (:func:`.kernels.fault_coins`' DEL
    flag; ``_live_split``'s ``live_del``).  ``row_ids``: the rows' global
    ids (on a mesh a block of them from ``shard.row0``)."""
    live = _edge_live(t, row_ids, nbrs, nbr_mask, parts)
    if plan is None:
        return live
    flags = kernels.fault_coins(nbrs, _up_all(plan, t, row_ids,
                                              shard.all_ids),
                                live=live, row0=shard.row0,
                                **_coins(plan, t, False, False))
    return (flags & FLAG_DEL) != 0


def _delay_terms(t: int, ring: int, classes: dict[int, torch.Tensor],
                 nbrs: torch.Tensor, nbr_mask: torch.Tensor,
                 parts: Partitions, row_ids: torch.Tensor,
                 plan: faults.FaultPlan | None, *,
                 shard: Shard = ONE_DEVICE) -> list:
    """[(ring slot, (rows, D) delivering edges)] of round ``t``'s delay
    classes: edge (i, d) of delay v (``classes[v]``, the mask ``delays ==
    v``) delivers the payload of send round ``t - (v - 1)`` from its
    slot, if it was live at that round (:func:`_live_del_at`); a class
    whose send round is below 0 has no term."""
    out = []
    for v, cls in classes.items():
        slot = send_slot(t, v, ring)
        if slot is not None:
            out.append((slot, _live_del_at(t - (v - 1), row_ids, nbrs,
                                           nbr_mask, parts, plan,
                                           shard=shard) & cls))
    return out


def _delay_sources(history: torch.Tensor, terms: list,
                   widen: Callable = _ident) -> list:
    """The payloads the delay ``terms`` deliver from: each class's ring
    slot, all-gathered from the ranks' blocks of the ring by ``widen`` on
    a mesh (one all-gather a class)."""
    return [widen(history[slot]) for slot, _ in terms]


def _gather_or_delayed(srcs: list, terms: list, nbrs: torch.Tensor,
                       like: torch.Tensor) -> torch.Tensor:
    """The latency ring's delivery (the reference's
    ``_gather_or_delayed``): one :func:`.kernels.gather_or` a delay
    class over its :func:`_delay_terms` edges, from the class's slot
    payload (``srcs``, :func:`_delay_sources`); zeros shaped like a row
    block of ``like`` (the ring) when no class delivers."""
    out = None
    for src, (_slot, live) in zip(srcs, terms):
        term = _gather_or(src, nbrs, live)
        out = term if out is None else out | term
    return torch.zeros((nbrs.shape[0],) + tuple(like.shape[2:]),
                       dtype=like.dtype, device=like.device) \
        if out is None else out


def _slot_table(terms: list, shape, up: torch.Tensor | None,
                device) -> torch.Tensor:
    """(N, D) int8: each edge's ring slot among the delay ``terms``
    (the classes are disjoint), -1 where it delivers nothing or the
    receiver is down (``up``): :func:`.kernels.prov_attribute`'s slot
    table."""
    slots = torch.full(tuple(shape), -1, dtype=torch.int8, device=device)
    for slot, live in terms:
        slots = slots.masked_fill(live, slot)
    if up is not None:
        slots = slots.masked_fill(~up[:, None], -1)
    return slots


def _stamp(prov, new: torch.Tensor, src: torch.Tensor, nbrs: torch.Tensor,
           t: int, **edges):
    """Round ``t``'s provenance stamps, in place on ``prov``
    (:func:`.kernels.prov_attribute`, the reference's
    ``_prov_attribute``).  On a mesh ``new``, ``nbrs`` (global ids) and
    the record are the rank's rows, ``src`` the whole node axis."""
    kernels.prov_attribute(new, src, nbrs, prov.arrival, prov.parent,
                           t_next=t + 1, **edges)
    return prov


def _stamp_ring(prov, new: torch.Tensor, history: torch.Tensor,
                srcs: list, terms: list, nbrs: torch.Tensor, t: int,
                up: torch.Tensor | None, shard: Shard):
    """Round ``t``'s stamps under the delay ring: off a mesh the kernel
    reads the ring itself, its slot table naming ring slots; on a mesh,
    where a rank holds its block of the ring, it reads the slots this
    round has already widened (``srcs``), stacked, the table renumbered
    into the stack, so the record adds no collective to the round (a
    round no class delivers in has nothing new to stamp)."""
    if shard.widen is _ident:
        return _stamp(prov, new, history, nbrs, t, slots=_slot_table(
            terms, nbrs.shape, up, nbrs.device))
    if not terms:
        return prov
    return _stamp(prov, new, torch.stack(srcs), nbrs, t, slots=_slot_table(
        [(k, live) for k, (_slot, live) in enumerate(terms)], nbrs.shape,
        up, nbrs.device))


def _sync_diff_pc(payload_full: torch.Tensor, recv_local: torch.Tensor,
                  nbrs: torch.Tensor,
                  live: torch.Tensor | None) -> torch.Tensor:
    """() int64 holding a uint32 — the total targeted-push volume of one
    sync wave: sum over delivering neighbor pairs (j, i) of
    |recv_j \\ recv_i|, computed at each destination i."""
    return kernels.sync_diff_pc(payload_full, recv_local, nbrs, live)


def _srv_ledger(srv_msgs: torch.Tensor, *, t: int, is_sync: bool,
                pcf: torch.Tensor, req_deg: torch.Tensor,
                ack_deg: torch.Tensor,
                diff: Callable[[], torch.Tensor],
                reduce_sum: Callable = _ident,
                base_once: bool = True) -> torch.Tensor:
    """The reference-accounted server ledger after round ``t``: floods
    charge `broadcast` to every requesting neighbor (``req_deg``) minus
    the sender (t == 0 rows are client-injected origins) plus one
    `broadcast_ok` per acknowledged delivery (``ack_deg``), at the
    frontier's popcount ``pcf``; sync rounds add read-per-requesting-
    neighbor + read_ok-per-acknowledging-neighbor + the targeted diff
    pushes and their acks (``diff()``, evaluated on sync rounds only).  On
    a mesh the shard's partial goes through ``reduce_sum``; without
    ``base_once`` (a word shard other than the first) the per-node read
    base is not charged again."""
    d2 = req_deg + ack_deg
    coef = d2 if t == 0 else (d2 - 2).clamp(min=0)
    inc = _dot32(pcf, coef)
    if is_sync:
        inc = inc + 2 * diff()
        if base_once:
            inc = inc + wrap32(d2.sum())
    return wrap32(srv_msgs + reduce_sum(wrap32(inc)))


def _is_sync(t: int, sync_every: int) -> bool:
    """Round ``t`` is a sync wave: every ``sync_every`` rounds after round
    0, and every round after it at ``sync_every=0`` (the reference's
    ``t % 0`` is 0)."""
    return t > 0 and (sync_every == 0 or t % sync_every == 0)


def _round(state: BroadcastState, *, row_ids: torch.Tensor,
           nbrs: torch.Tensor, nbr_mask: torch.Tensor, parts: Partitions,
           sync_every: int, deg: torch.Tensor | None = None,
           plan: faults.FaultPlan | None = None, dup_on: bool = False,
           union_block: int | None = None,
           classes: dict[int, torch.Tensor] | None = None,
           prov=None, shard: Shard = ONE_DEVICE):
    """One node-major (adjacency-gather) round — the reference's
    ``_round``.  On a mesh (``shard``) ``widen`` all-gathers the payload
    blocks and ``reduce_sum`` globalizes the ledgers, ``row_ids`` are the
    local rows' global ids from ``shard.row0`` and ``nbrs`` global ids.
    ``deg`` is
    the topology degree ``nbr_mask.sum(1)`` (int64; computed when not
    given).  With a ``plan`` the round is :func:`_round_plan`.  On a
    round with no active partition window the edge mask is never built:
    the kernels deliver exactly the edges with ``nbrs >= 0``.  The sync
    diff runs on sync rounds only (``t`` is a host int), which leaves the
    ledger as the reference's every-round diff masked off elsewhere.  The
    delivery (``new = gather_or(payload) & ~received``, ``received |
    new``) is one fused launch, :func:`.kernels.gather_flood_round`.

    With ``classes`` (per distinct edge delay v, the (N, D) mask ``delays
    == v``) the latency ring delivers instead: the payload is pushed into
    ring slot ``t % L`` and :func:`_gather_or_delayed` delivers each
    class from the slot of its send round.  Sends are still charged now,
    over the edges live at send time, and the server ledger diffs against
    current (not round-trip stale) state, the reference's documented
    approximation.

    With ``prov`` (a :class:`.provenance.BroadcastProv`) the round also
    stamps, in place, each new bit's arrival round and the neighbour of
    the first direction whose delivered word carries it
    (:func:`.kernels.prov_attribute` over the round's own payload, flag
    bytes or ring slots), and returns ``(state, prov)``."""
    if plan is not None:
        return _round_plan(state, row_ids=row_ids, nbrs=nbrs,
                           nbr_mask=nbr_mask, parts=parts,
                           sync_every=sync_every, deg=deg, plan=plan,
                           dup_on=dup_on, union_block=union_block,
                           classes=classes, prov=prov, shard=shard)
    t = state.t
    is_sync = _is_sync(t, sync_every)
    rec0, fr0 = state.received, state.frontier
    # frontier ⊆ received, so the anti-entropy payload is just `received`
    payload = rec0 if is_sync else fr0
    # the ring delivers from its own slots: the whole payload is needed
    # then only by a sync wave's server-ledger diff
    payload_full = (shard.widen(payload) if classes is None or (
        is_sync and state.srv_msgs is not None) else None)
    live = (_edge_live(t, row_ids, nbrs, nbr_mask, parts)
            if parts.active(t) else None)
    deg_topo = nbr_mask.sum(dim=1) if deg is None else deg
    live_deg = deg_topo if live is None else live.sum(dim=1)
    pc = kernels.col_popcount(payload, node_major=True)
    # one value-message per (value, live edge)
    sent = shard.reduce_sum(_dot32(pc, live_deg))
    srv = None
    if state.srv_msgs is not None:
        # partitions only: every topology neighbor is asked, every live
        # edge delivers and acknowledges, and diffs flow over live edges
        srv = _srv_ledger(
            state.srv_msgs, t=t, is_sync=is_sync,
            pcf=kernels.col_popcount(fr0, node_major=True) if is_sync
            else pc, req_deg=deg_topo, ack_deg=live_deg,
            diff=lambda: _sync_diff_pc(payload_full, rec0, nbrs, live),
            reduce_sum=shard.reduce_sum, base_once=shard.base_once)
    history = None
    if classes is None:
        new, received = kernels.gather_flood_round(payload_full, rec0, nbrs,
                                                   live)
        if prov is not None:
            prov = _stamp(prov, new, payload_full, nbrs, t, flags=None
                          if live is None else live.to(torch.uint8)
                          * kernels.FLAG_DEL)
    else:
        history = _ring_push(state.history, payload, t)
        terms = _delay_terms(t, history.shape[0], classes, nbrs, nbr_mask,
                             parts, row_ids, None)
        srcs = _delay_sources(history, terms, shard.widen)
        new = _gather_or_delayed(srcs, terms, nbrs, history) & ~rec0
        received = rec0 | new
        if prov is not None:
            prov = _stamp_ring(prov, new, history, srcs, terms, nbrs, t,
                               None, shard)
    out = BroadcastState(received=received, frontier=new, t=t + 1,
                         msgs=wrap32(state.msgs + sent), srv_msgs=srv,
                         history=history)
    return out if prov is None else (out, prov)


def _coins(plan: faults.FaultPlan, t: int, dup_on: bool,
           out_ok: bool) -> dict:
    """:func:`.kernels.fault_coins`' scalars at round ``t``: which
    streams are active (``t`` below their horizon, a non-zero rate)."""
    return dict(t=t, seed=plan.seed, loss_num=plan.loss_num,
                dup_num=plan.dup_num,
                loss=t < plan.loss_until and plan.loss_num > 0,
                dup=dup_on and t < plan.dup_until and plan.dup_num > 0,
                out_ok=out_ok)


def _round_plan(state: BroadcastState, *, row_ids: torch.Tensor,
                nbrs: torch.Tensor, nbr_mask: torch.Tensor,
                parts: Partitions, sync_every: int,
                deg: torch.Tensor | None, plan: faults.FaultPlan,
                dup_on: bool, union_block: int | None,
                classes: dict[int, torch.Tensor] | None = None, prov=None,
                shard: Shard = ONE_DEVICE):
    """The faulted gather round (the reference's ``_round`` with a
    ``plan``).  First the amnesia rows' ``received`` / ``frontier`` are
    wiped; then :func:`.kernels.fault_coins` gives each edge its flags
    (sent, delivered, duplicated, reply not lost) and
    :func:`.kernels.faulted_gather_round` delivers ``payload`` over the
    delivered edges and the wiped ``received`` set over the dup edges.
    ``msgs`` charges every sent edge at the payload's popcount (loss
    counts as sent) and every dup edge at its source's received set.

    The server ledger (the reference's loss/crash accounting): requests
    charged at send time from up rows only (``req_deg``), replies only
    where the reply's coin survives (``ack``: sent and OUT_OK), and sync
    diffs over the edges whose two coins survive (DEL and OUT_OK).

    ``union_block`` with the server ledger off streams the round over
    destination slabs of that many rows (:func:`.engine.scan_blocks`),
    one fault_coins + faulted_gather_round pair a slab, so only one
    slab's flags and partition mask live at a time; the coins are
    stateless (t, src, dst) hashes, so the result is the materialized
    round's bit for bit.

    With delay ``classes`` (:func:`_round`) the latency ring delivers
    what was live at each class's send round, a node down now receives
    nothing (a message in flight to a crashed process dies with it), and
    a dup edge re-delivers its in-flight payload, which the dedup absorbs:
    it is charged at the payload's popcount at its source and delivers
    nothing new.

    ``prov``: :func:`_round`'s provenance stamps, over the flag bytes
    (one hop: DEL edges deliver the payload, DUP edges the wiped
    ``received`` rows) or the ring slots of the live edges, a receiver
    down now getting nothing; the round then runs materialized.

    On a mesh (``shard``) the coins hash the rows' global ids (from
    ``shard.row0``), their liveness operand covers every node
    (``shard.all_ids``), the payload
    is all-gathered and, on a round with an active dup stream, so is the
    wiped ``received`` set (the dup rows): two all-gathers and the
    ledgers' all-reduce a round.  The stamps read those same gathered
    rows (:func:`_stamp`, :func:`_stamp_ring`)."""
    t = state.t
    wipe = faults.amnesia(plan, t, row_ids)[:, None]
    rec0 = state.received.masked_fill(wipe, 0)
    fr0 = state.frontier.masked_fill(wipe, 0)
    is_sync = _is_sync(t, sync_every)
    # frontier ⊆ received, so the anti-entropy payload is just `received`
    payload = rec0 if is_sync else fr0
    srv_on = state.srv_msgs is not None
    coins = _coins(plan, t, dup_on, out_ok=srv_on)
    # under delays the ring delivers from its own slots: the whole payload
    # is needed then only for the dup charge at its source and the
    # server ledger's sync diff
    payload_full = (shard.widen(payload) if classes is None or coins["dup"]
                    or srv_on else None)
    row0 = shard.row0
    up_all = _up_all(plan, t, row_ids, shard.all_ids)
    up = up_all[row0:row0 + nbrs.shape[0]]
    dup_rows = (shard.widen(rec0) if coins["dup"] and classes is None
                else None)
    pc = kernels.col_popcount(payload, node_major=True)
    windows = bool(parts.active(t))

    def deliver(lo: int, hi: int):
        """(flags, new, received, sent) of destination rows [lo, hi)."""
        nb = nbrs[lo:hi]
        live = (_edge_live(t, row_ids[lo:hi], nb, nbr_mask[lo:hi], parts)
                if windows else None)
        flags = kernels.fault_coins(nb, up_all, live=live, row0=row0 + lo,
                                    **coins)
        new, rec, dup_pc = kernels.faulted_gather_round(
            payload_full, dup_rows, rec0[lo:hi], nb, flags)
        sent = _dot32(pc[lo:hi], (flags & FLAG_SEND).sum(dim=1)) + dup_pc
        return flags, new, rec, sent

    if union_block is not None and not srv_on and prov is None \
            and classes is None:
        def slab(carry, lo):
            news, recs, sent = carry
            _, new, rec, s = deliver(lo, lo + union_block)
            return news + [new], recs + [rec], wrap32(sent + s)

        news, recs, sent = scan_blocks(slab, ([], [], 0), nbrs.shape[0],
                                       union_block)
        sent = torch.as_tensor(sent, dtype=torch.int64, device=pc.device)
        return BroadcastState(received=torch.cat(recs),
                              frontier=torch.cat(news), t=t + 1,
                              msgs=wrap32(state.msgs
                                          + shard.reduce_sum(sent)),
                              srv_msgs=None)
    history = None
    if classes is None:
        flags, new, received, sent = deliver(0, nbrs.shape[0])
        if prov is not None:
            prov = _stamp(prov, new, payload_full, nbrs, t, flags=flags,
                          dup=dup_rows)
    else:
        live = _edge_live(t, row_ids, nbrs, nbr_mask, parts) if windows \
            else None
        flags = kernels.fault_coins(nbrs, up_all, live=live, row0=row0,
                                    **coins)
        sent = _dot32(pc, (flags & FLAG_SEND).sum(dim=1))
        if coins["dup"]:
            # a dup edge re-delivers its in-flight payload: charged at
            # the payload's popcount at its source
            pc_src = (pc if payload_full is payload else
                      kernels.col_popcount(payload_full, node_major=True))
            src = nbrs.clamp(0, payload_full.shape[0] - 1).to(torch.int64)
            dup = (flags & kernels.FLAG_DUP) != 0
            sent = wrap32(sent + torch.where(dup, pc_src[src], 0).sum(
                dtype=torch.int64))
        history = _ring_push(state.history, payload, t)
        terms = _delay_terms(t, history.shape[0], classes, nbrs, nbr_mask,
                             parts, row_ids, plan, shard=shard)
        srcs = _delay_sources(history, terms, shard.widen)
        inbox = _gather_or_delayed(srcs, terms, nbrs, history)
        new = inbox.masked_fill(~up[:, None], 0) & ~rec0
        received = rec0 | new
        if prov is not None:
            prov = _stamp_ring(prov, new, history, srcs, terms, nbrs, t, up,
                               shard)
    srv = None
    if srv_on:
        # a down row asks nothing; a reply exists where the request was
        # sent and the reply's coin survives; a sync pair diffs where
        # both coins survive
        deg_topo = nbr_mask.sum(dim=1) if deg is None else deg
        ack, both = FLAG_SEND | FLAG_OUT_OK, FLAG_DEL | FLAG_OUT_OK
        srv = _srv_ledger(
            state.srv_msgs, t=t, is_sync=is_sync,
            pcf=kernels.col_popcount(fr0, node_major=True) if is_sync
            else pc, req_deg=torch.where(up, deg_topo, 0),
            ack_deg=((flags & ack) == ack).sum(dim=1),
            diff=lambda: _sync_diff_pc(payload_full, rec0, nbrs,
                                       (flags & both) == both),
            reduce_sum=shard.reduce_sum, base_once=shard.base_once)
    out = BroadcastState(received=received, frontier=new, t=t + 1,
                         msgs=wrap32(state.msgs
                                     + shard.reduce_sum(wrap32(sent))),
                         srv_msgs=srv, history=history)
    return out if prov is None else (out, prov)


def delay_classes(delays: torch.Tensor,
                  delay_set: tuple = ()) -> dict[int, torch.Tensor]:
    """{v: (N, D) bool ``delays == v``} over the distinct delays
    (``delay_set``, or those of ``delays`` when empty)."""
    if not delay_set:
        delay_set = tuple(int(v) for v in torch.unique(delays.cpu()))
    return {int(v): delays == int(v) for v in delay_set}


def flood_step(state: BroadcastState, *, nbrs: torch.Tensor,
               nbr_mask: torch.Tensor, parts: Partitions, sync_every: int,
               delays=None, delay_set: tuple = (),
               plan: faults.FaultPlan | None = None, dup_on: bool = False,
               union_block: int | None = None,
               prov=None):
    """Single-device node-major round, under an optional fault ``plan``
    (``dup_on``: its dup stream; ``union_block``: stream the faulted
    round over destination slabs) and per-edge ``delays`` ((N, D) int
    rounds >= 1; ``delay_set`` their distinct values, derived from the
    tensor when empty; the state then carries its (L, N, W) ring).  With
    ``prov`` (a :class:`.provenance.BroadcastProv`) it stamps the record
    in place and returns ``(state, prov)``; the faulted round then runs
    materialized (``union_block`` is ignored, as in the reference)."""
    if prov is not None and not isinstance(prov, provenance.BroadcastProv):
        raise TypeError("prov must be a provenance.BroadcastProv "
                        f"(BroadcastSim.provenance_state), got "
                        f"{type(prov).__name__}")
    if plan is not None and plan.n_nodes != nbrs.shape[0]:
        raise ValueError(f"FaultPlan is for {plan.n_nodes} nodes, the "
                         f"table has {nbrs.shape[0]}")
    classes = None
    if delays is not None:
        if state.history is None:
            raise ValueError("delays need the state's history ring")
        if union_block is not None:
            raise ValueError("the delays ring keeps the materialized shape: "
                             "pass union_block=None")
        classes = delay_classes(torch.as_tensor(delays, device=nbrs.device),
                                delay_set)
    row_ids = torch.arange(nbrs.shape[0], device=nbrs.device)
    return _round(state, row_ids=row_ids, nbrs=nbrs, nbr_mask=nbr_mask,
                  parts=parts, sync_every=sync_every, plan=plan,
                  dup_on=dup_on, union_block=union_block, classes=classes,
                  prov=prov)


# -- the words-major structured path ------------------------------------


def _round_wm(state: BroadcastState, *, deg: torch.Tensor, sync_every: int,
              exchange: Callable[[torch.Tensor], torch.Tensor],
              sync_diff: Callable[[torch.Tensor], torch.Tensor] | None = None,
              live: torch.Tensor | None = None, faulted=None,
              delayed_exchange: Callable | None = None,
              shard: Shard = ONE_DEVICE) -> BroadcastState:
    """Words-major round (the reference's ``_round_wm``, plain, partition
    and delay modes).  On a mesh ``shard.reduce_sum`` globalizes the
    ledgers' shard partials, and the all-gather fallback (a shape with no
    halo form) widens the payload to the full node axis
    (``shard.widen``), runs the full-axis exchange and cuts the local
    block back out (``shard.local``, ``shard.cols`` for the live degree);
    the halo path leaves those the identity and hands the halo
    closures.  ``deg`` is
    the per-node topology degree (int64).
    Under an active partition window ``live`` holds the round's (D,
    ceil(N/32)) packed per-direction liveness (:meth:`BroadcastSim.
    _live_rows`) and ``faulted`` the :class:`.structured.StructuredFaults`
    bundle whose masked closures take it; the ledgers then use the live
    degree ``live.sum(0)``, the gather path's per-edge accounting.  With
    no active window every edge is live and the plain closures deliver
    what the masked ones would under the bare exists rows.  With
    ``delayed_exchange(history, t)`` the payload goes into the state's
    ring and that closure delivers from it (per-direction delay classes,
    random per-edge delays; ``faulted`` then only gives the ledger's
    masked sync diff)."""
    t = state.t
    is_sync = _is_sync(t, sync_every)
    payload = state.received if is_sync else state.frontier
    payload_full = shard.widen(payload)
    if live is None:
        live_deg = deg
        deliver, diff = exchange, sync_diff
    else:
        live_deg = shard.cols(kernels.count_rows(live,
                                                 payload_full.shape[1]))
        deliver = lambda p: faulted.exchange(p, live)  # noqa: E731
        diff = lambda r: faulted.sync_diff(r, live)  # noqa: E731
    pc = kernels.col_popcount(payload)
    sent = shard.reduce_sum(_dot32(pc, live_deg))
    srv = None
    if state.srv_msgs is not None:
        srv = _srv_ledger(
            state.srv_msgs, t=t, is_sync=is_sync,
            pcf=kernels.col_popcount(state.frontier) if is_sync else pc,
            req_deg=deg, ack_deg=live_deg,
            diff=lambda: diff(state.received), reduce_sum=shard.reduce_sum,
            base_once=shard.base_once)
    history = None
    if delayed_exchange is None:
        inbox = shard.local(deliver(payload_full))
    else:
        history = _ring_push(state.history, payload, t)
        inbox = delayed_exchange(history, t)
    new = inbox & ~state.received
    return BroadcastState(received=state.received | new, frontier=new,
                          t=t + 1, msgs=wrap32(state.msgs + sent),
                          srv_msgs=srv, history=history)


def _dup_charge(src_pc: Callable, dup: torch.Tensor,
                counts: torch.Tensor,
                cols: Callable = _ident) -> torch.Tensor:
    """() int64 holding a uint32: the popcount at the source of every dup
    edge.  ``counts`` is the (1, N) per-node popcount; ``src_pc`` moves
    it to each direction's contract positions (a repeat, shift or roll:
    no gather), where the packed ``dup`` rows select it; ``cols`` keeps a
    rank's columns of a full-axis charge (the all-gather
    fallback)."""
    rows = kernels.unpack_bits(dup, counts.shape[1])
    at = torch.cat([src_pc(d, counts) for d in range(rows.shape[0])])
    return wrap32(cols(torch.where(rows, at, 0)).sum(
        dtype=torch.int64))


def _round_wm_nem(state: BroadcastState, *, nem, arrs, plan: faults.FaultPlan,
                  parts: Partitions, sync_every: int, dup_on: bool,
                  deg_topo: torch.Tensor,
                  shard: Shard = ONE_DEVICE) -> BroadcastState:
    """Words-major round under the full nemesis (the reference's
    ``_round_wm_nem``): a compiled plan (crash /
    restart amnesia, per-direction loss, duplicate delivery) composed
    with partition windows, gather-free and bit-exact with the gather
    path's faulted round.  ``nem`` is the
    :class:`.structured.StructuredNemesis` bundle and ``arrs`` its
    operand on the sim's device; ``deg_topo`` the degree contract's
    topology degree.

    The amnesia columns are wiped at crash entry; ``msgs`` charges the
    payload against the live SEND degree (partitions and both endpoints
    up; a lost message was still sent); each direction's term is gated
    by liveness and its loss coin (:func:`.faults.wm_live_del`), and dup
    edges re-deliver the source's whole received set, charged at its
    popcount.  The server ledger runs for loss-only plans (the sim keeps
    it off otherwise): requests at send time, replies where the reply's
    coin survives, sync diffs over the pairs whose two coins survive
    (:func:`.faults.wm_srv_rows`).

    With the bundle's ``dir_delays`` the payload goes into the state's
    ring and direction d delivers, from the slot of its send round ``t -
    (dir_delays[d] - 1)``, what the liveness and loss coins of that round
    let through (one :func:`.faults.wm_live_del` a distinct delay); a
    column down now receives nothing, and a dup edge re-delivers its
    in-flight payload: charged at the payload's popcount at its source,
    nothing new delivered.  The server ledger is off there.

    On a mesh ``shard.reduce_sum`` globalizes the ledgers.  The halo path
    hands the bundle's halo closures (``nem`` with its ``sharded_*``
    bound) and a rank's block of the mask operand
    (:meth:`.faults.WMNemesisArrays.shard`), so every mask lands on local
    columns; the all-gather fallback keeps the full operand and closures,
    widens the payload (``shard.widen``), cuts the local block back out
    of the inbox (``shard.local``) and of every full-axis column row
    (``shard.cols``)."""
    t = state.t
    rec0, fr0 = state.received, state.frontier
    wipe = faults.wm_wipe_cols(plan, t, arrs.down_cols)
    if wipe is not None:
        wipe = shard.cols(wipe)
        rec0 = rec0.masked_fill(wipe[None, :], 0)
        fr0 = fr0.masked_fill(wipe[None, :], 0)
    is_sync = _is_sync(t, sync_every)
    payload = rec0 if is_sync else fr0
    n = deg_topo.shape[0]
    ps, pe = parts.starts, parts.ends
    deg_live = faults.wm_live_rows(plan, t, arrs, ps, pe, deg=True)
    live_deg = shard.cols(deg_topo if deg_live is arrs.deg_exists
                          else kernels.count_rows(deg_live, n))
    pc = kernels.col_popcount(payload)
    sent = _dot32(pc, live_deg)
    srv = None
    if state.srv_msgs is not None:
        _, ack, both = faults.wm_srv_rows(plan, t, arrs, ps, pe,
                                          live=deg_live)
        srv = _srv_ledger(
            state.srv_msgs, t=t, is_sync=is_sync,
            pcf=kernels.col_popcount(fr0) if is_sync else pc,
            req_deg=deg_topo,
            ack_deg=live_deg if ack is deg_live else kernels.count_rows(
                ack, n),
            diff=lambda: nem.sync_diff(rec0, both),
            reduce_sum=shard.reduce_sum, base_once=shard.base_once)
    history = None
    if nem.dir_delays is None:
        live_del, dup = faults.wm_live_del(plan, t, arrs, ps, pe, dup_on)
        inbox = shard.local(nem.exchange(shard.widen(payload), live_del))
        if dup is not None:
            rec_full = shard.widen(rec0)
            inbox = inbox | shard.local(nem.exchange(rec_full, dup))
            counts = kernels.col_popcount(rec_full)[None, :]
            sent = sent + _dup_charge(nem.src_pc, dup, counts, shard.cols)
    else:
        dd = nem.dir_delays
        history = _ring_push(state.history, payload, t)
        ring = history.shape[0]
        # one liveness and coin evaluation a distinct delay, at its send
        # round, shared by the directions of that delay
        coins = {v: faults.wm_live_del(plan, t - (v - 1), arrs, ps, pe,
                                       False)[0]
                 for v in sorted(set(dd)) if t - (v - 1) >= 0}
        ring_full = history if shard.widen is _ident else torch.stack(
            [shard.widen(h) for h in history])
        inbox = shard.local(nem.ring_exchange(ring_full, [
            (d, send_slot(t, v, ring), coins[v][d])
            for d, v in enumerate(dd) if v in coins]))
        if active_windows(plan.starts, plan.ends, t):
            # a message in flight to a node that crashed before delivery
            # dies with the process
            up = shard.cols(faults.wm_up_cols(plan, t, arrs.down_cols))
            inbox = inbox.masked_fill(~up[None, :], 0)
        if dup_on:
            _, dup = faults.wm_live_del(plan, t, arrs, ps, pe, True)
            if dup is not None:
                counts = (pc if shard.widen is _ident else
                          kernels.col_popcount(shard.widen(payload)))[None, :]
                sent = sent + _dup_charge(nem.src_pc, dup, counts,
                                          shard.cols)
    new = inbox & ~rec0
    return BroadcastState(received=rec0 | new, frontier=new, t=t + 1,
                          msgs=wrap32(state.msgs
                                      + shard.reduce_sum(wrap32(sent))),
                          srv_msgs=srv, history=history)


def _degree_masks(np_deg: np.ndarray, device: torch.device):
    """(distinct degrees, per-degree (N,) bool masks) for the closed-form
    flood ledger."""
    degs = sorted(set(np_deg.tolist()))
    return degs, [torch.as_tensor(np_deg == d, device=device) for d in degs]


def _flood_loop(exchange, rounds: int):
    """The pure flood: ``rounds`` fused exchange+merge rounds through
    ``exchange.flood_round``.  The returned ``loop(received, frontier)``
    CONSUMES its inputs (received is updated in place and the frontier
    buffer is reused) and returns ``(received, frontier)``."""
    def loop(rec: torch.Tensor, fr: torch.Tensor):
        nxt = torch.empty_like(fr)
        for _ in range(rounds):
            exchange.flood_round(rec, fr, nxt)
            fr, nxt = nxt, fr
        return rec, fr

    return loop


def _flood_ledger(state: BroadcastState, rec: torch.Tensor,
                  fr: torch.Tensor, degs, masks, rounds: int,
                  reduce_sum: Callable = _ident) -> BroadcastState:
    """Recover the value-message ledger of a pure flood in closed form:
    every (node, value) bit in `received` was in the frontier of
    exactly one executed round — flooded to deg neighbors then —
    except the final frontier (arrived last round, never flooded), so
    msgs += sum_i deg_i * (pc_i(received) - pc_i(frontier)); on a mesh
    each shard's partial goes through ``reduce_sum``."""
    dpc = (kernels.col_popcount(rec)
           - kernels.col_popcount(fr)).to(torch.int64)
    sent = torch.zeros((), dtype=torch.int64, device=rec.device)
    for d, m in zip(degs, masks):
        sent = wrap32(sent + d * wrap32(torch.where(m, dpc, 0).sum()))
    return dataclasses.replace(state, received=rec, frontier=fr,
                               t=state.t + rounds,
                               msgs=wrap32(state.msgs + reduce_sum(sent)))


def _check_delay_modes(words_major: bool, shape: tuple, n_windows: int, *,
                       delays, delayed, edge_delayed, faulted, df: bool,
                       ef: bool) -> None:
    """The reference's checks of the delay modes' combinations (``df`` /
    ``ef``: the ``delayed`` / ``edge_delayed`` bundle carries partition
    masks); ``shape`` is the neighbor table's (N, D)."""
    n = shape[0]
    if edge_delayed is not None:
        if not words_major:
            raise ValueError("edge_delayed needs a structured exchange")
        if delays is not None or delayed is not None or faulted is not None:
            raise ValueError("edge_delayed is mutually exclusive with "
                             "delays/delayed/faulted")
        if ef:
            if n_windows == 0:
                raise ValueError(
                    "FaultedEdgeDelays needs a partition schedule; use "
                    "make_edge_delayed for the window-free case")
            if edge_delayed.del_same.shape[0] != n_windows \
                    or edge_delayed.del_same.shape[-1] != n:
                raise ValueError("FaultedEdgeDelays masks do not match "
                                 "the partition schedule")
        elif n_windows > 0:
            raise ValueError(
                "composing random per-edge delays with partitions on the "
                "structured path needs a FaultedEdgeDelays bundle "
                "(structured.make_edge_delayed_faulted)")
    if delayed is not None:
        if not words_major:
            raise ValueError("delayed needs a structured exchange")
        if delays is not None:
            raise ValueError("per-edge `delays` and per-direction "
                             "`delayed` are mutually exclusive")
        if df:
            if faulted is not None:
                raise ValueError("pass EITHER faulted= or a FaultedDelayed "
                                 "bundle — the bundle carries its own masks")
            if n_windows == 0:
                raise ValueError("FaultedDelayed needs a partition "
                                 "schedule; use make_delayed for the "
                                 "fault-free case")
            if delayed.same.shape[0] != n_windows \
                    or delayed.same.shape[-1] != n:
                raise ValueError("FaultedDelayed masks do not match the "
                                 "partition schedule")
        elif n_windows > 0 or faulted is not None:
            raise ValueError(
                "composing delays with partitions on the structured path "
                "needs a FaultedDelayed bundle "
                "(structured.make_delayed_faulted)")
    if delays is not None:
        if words_major:
            raise ValueError("per-edge delays need the gather path")
        d = np.asarray(delays)
        if d.shape != tuple(shape):
            raise ValueError("delays must match nbrs shape")
        if d.min() < 1:
            raise ValueError("edge delays are rounds >= 1")


class BroadcastSim:
    """Round-synchronous broadcast simulator (the reference's
    ``BroadcastSim``) on one device, under partition schedules, fault
    plans and per-hop delays on both layouts, or on a 1-D mesh (``mesh=``:
    one rank a block of the node axis, every mode).

    - **words-major (W, N)** with a structured ``exchange`` from
      :func:`.structured.make_exchange`: gather-free delivery for the
      named topologies, with the fused flood-round kernels on its
      fixed-trip path; a partition schedule through ``faulted=``, a
      fault plan through ``nemesis=``;
    - **node-major (N, W)** with ``exchange=None``: the adjacency gather
      over ``nbrs`` (any topology), under an optional partition schedule
      ``parts`` and nemesis ``fault_plan``.
    """

    def __init__(self, nbrs: np.ndarray, *, n_values: int,
                 sync_every: int = 8, parts: Partitions | None = None,
                 exchange=None,
                 sync_diff: Callable[[torch.Tensor], torch.Tensor]
                 | None = None,
                 srv_ledger: bool = True,
                 faulted=None,
                 fault_plan: faults.FaultPlan | None = None,
                 nemesis=None,
                 union_block=None,
                 delays: np.ndarray | None = None,
                 delayed=None,
                 edge_delayed=None,
                 device: str | torch.device | None = None,
                 mesh=None,
                 sharded_exchange=None,
                 sharded_sync_diff=None,
                 dcn_mode=None) -> None:
        """``nbrs``: (N, D) int32 neighbor table padded with -1
        (parallel/topology.py).  ``exchange``: a structured exchange from
        :func:`.structured.make_exchange` (it carries the fused flood
        round), or None for the node-major gather path.  ``sync_diff``:
        the matching :func:`.structured.make_sync_diff` closure, which
        the words-major server ledger needs (the gather path computes
        its own).  ``parts``: a partition schedule; on the structured
        path it needs ``faulted`` (:func:`.structured.make_faulted` over
        the same groups) or ``nemesis``.  ``fault_plan``: a
        :class:`.faults.FaultPlan` (crash, loss, dup, membership on the
        gather path), its dup stream on when its ``dup_num`` is; a dup
        stream needs ``srv_ledger=False``.  ``nemesis``: the
        :class:`.structured.StructuredNemesis` bundle of the same spec
        (:func:`.structured.make_nemesis`, partition groups included),
        which a plan on the structured path needs; it subsumes
        ``faulted``, and the server ledger stays on there only for
        loss-only plans.  ``union_block``: stream the gather path's
        faulted rounds over destination slabs
        (:func:`.engine.resolve_block`: an int, ``"auto"``,
        ``"materialized"``, or None for the ``GG_UNION_BLOCK`` env);
        blocked rounds keep no server ledger.  Per-hop latency, each mode
        with its ring of past payloads in the state: ``delays``, (N, D)
        per-edge rounds >= 1 on the gather path (the server ledger goes
        off under a plan); ``delayed``, per-direction delay classes on the
        words-major path (:func:`.structured.make_delayed`, or
        :func:`.structured.make_delayed_faulted` under a partition
        schedule); ``edge_delayed``, random per-edge delays there
        (:func:`.structured.make_edge_delayed` /
        :func:`.structured.make_edge_delayed_faulted`); the nemesis's
        through ``make_nemesis(dir_delays=)``.  ``device``: where the
        state lives (default CUDA; raises if there is none).

        ``mesh``: a :class:`..parallel.mesh.Mesh` — this rank runs its
        block of the node axis on ``mesh.device`` (N must divide evenly
        over the node shards: a 1-D mesh's ranks, a hierarchical mesh's
        hosts x nodes), and on a mesh with a ``words`` axis its block of
        the bitset's words too (the words must divide evenly over it),
        every rank calling every method in the same order.
        ``sharded_exchange`` / ``sharded_sync_diff``: the halo closures
        (:func:`.structured.make_sharded_exchange` /
        :func:`.structured.make_sharded_sync_diff`, bound here); a
        words-major sim without one takes the all-gather fallback, with
        the server ledger off as in the reference.  Every mode above runs
        on a mesh: the fault, delay and nemesis bundles built with
        ``n_shards=`` carry their own halo closures (the delay bundles
        refuse a mesh without them, as the reference does; the nemesis
        falls back to the all-gather), and the gather path's plan,
        ``delays`` and ``union_block`` run over the all-gathered payload.
        ``dcn_mode``: the hosts level's schedule on a hierarchical mesh
        (:func:`.engine.resolve_dcn_mode`; None defers to the env):
        ``sync`` or ``pipelined`` (the ledgers' sums split into two
        half-blocks, bit-exact); a ``stale:k`` mode refuses, as the
        reference's does."""
        from .engine import check_mesh, dcn_psum, resolve_dcn_mode
        from .structured import Halo

        if exchange is not None and not hasattr(exchange, "flood_round"):
            raise TypeError("exchange must come from "
                            "structured.make_exchange")
        if sharded_exchange is not None and exchange is None:
            raise ValueError("sharded_exchange requires exchange")
        for name, value in (("sharded_exchange", sharded_exchange),
                            ("sharded_sync_diff", sharded_sync_diff)):
            if value is not None and not isinstance(value, Halo):
                raise TypeError(f"BroadcastSim({name}=...) takes a "
                                "structured.Halo (make_sharded_exchange "
                                "/ make_sharded_sync_diff)")
        check_mesh(mesh)
        self._dcn = resolve_dcn_mode(dcn_mode)
        if self._dcn.stale_k:
            raise ValueError(
                f"dcn_mode={self._dcn.label()!r}: broadcast has no "
                "certified staleness semantics — its delivery plane is "
                "the halo/widen exchange and the srv ledger calibrates "
                "against synchronous round accounting; run sync or "
                "pipelined")
        n_wsh = word_shards(mesh)
        if mesh is not None:
            if nbrs.shape[0] % node_shards(mesh):
                raise ValueError(f"{nbrs.shape[0]} nodes do not shard "
                                 f"evenly over {node_shards(mesh)} ranks")
            if num_words(n_values) % n_wsh:
                raise ValueError(
                    f"{num_words(n_values)} words of {n_values} values do "
                    f"not shard evenly over {n_wsh} word shards")
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        n = nbrs.shape[0]
        parts = Partitions.none(n) if parts is None else parts
        if parts.group.shape[1:] != (n,):
            raise ValueError(f"Partitions group {tuple(parts.group.shape)}"
                             f" is not (P, {n})")
        words_major = exchange is not None
        n_windows = parts.n_windows
        # the delay bundles that carry their own partition masks
        df = delayed is not None and hasattr(delayed, "same")
        ef = edge_delayed is not None and hasattr(edge_delayed, "del_same")
        _check_delay_modes(words_major, nbrs.shape, n_windows, delays=delays,
                           delayed=delayed, edge_delayed=edge_delayed,
                           faulted=faulted, df=df, ef=ef)
        if df or ef:
            faulted = delayed if df else edge_delayed
        self._faulted = faulted if words_major and n_windows else None
        if words_major and n_windows and faulted is None and nemesis is None:
            raise ValueError(
                "a words-major structured run under a partition "
                "schedule needs the masked closures: pass "
                "faulted=structured.make_faulted(topology, n, groups)")
        if self._faulted is not None and (
                faulted.same.shape[0] != n_windows
                or faulted.same.shape[-1] != n):
            raise ValueError(
                "StructuredFaults masks do not match the partition "
                f"schedule: same{tuple(faulted.same.shape)} vs "
                f"{n_windows} windows x {n} nodes")
        self._nem = nemesis
        if nemesis is not None:
            if not words_major:
                raise ValueError(
                    "nemesis= is the words-major structured FaultPlan "
                    "path — it needs a structured exchange (the gather "
                    "path takes the plan alone)")
            if fault_plan is None:
                raise ValueError(
                    "nemesis= carries the structured masks FOR a "
                    "FaultPlan — pass fault_plan=spec.compile() too")
            if faulted is not None or delays is not None \
                    or delayed is not None or edge_delayed is not None:
                raise ValueError(
                    "nemesis= subsumes delays/delayed/edge_delayed/"
                    "faulted: compose partition windows via parts= and "
                    "per-direction delays via make_nemesis(dir_delays=)")
            if nemesis.arrs.same.shape[0] != n_windows \
                    or nemesis.arrs.n_nodes != n:
                raise ValueError(
                    "StructuredNemesis masks do not match the "
                    "partition schedule: "
                    f"same{tuple(nemesis.arrs.same.shape)} vs "
                    f"{n_windows} windows x {n} nodes")
            if nemesis.arrs.down_pair.shape[0] != len(fault_plan.starts):
                raise ValueError(
                    "StructuredNemesis crash masks do not match the "
                    "FaultPlan's crash windows — rebuild the bundle "
                    "from the same NemesisSpec")
        if fault_plan is not None and words_major and nemesis is None:
            raise ValueError(
                "a FaultPlan on the words-major structured path "
                "needs the mask bundle: pass "
                "nemesis=structured.make_nemesis(topology, n, "
                "spec, ...) — or drop exchange=/sharded_exchange= "
                "for the gather path")
        if union_block is not None and (words_major or delays is not None):
            raise ValueError(
                "union_block streams the GATHER path's 1-hop faulted "
                "rounds; the words-major path is already gather-free "
                "and the delays ring keeps the materialized shape")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_nodes = n
        self.n_values = n_values
        self.n_words = num_words(n_values)
        self.sync_every = sync_every
        self.exchange = exchange
        self.words_major = words_major
        self.parts = parts.to(self.device)
        self._host_deg = (nbrs >= 0).sum(axis=1).astype(np.int64)
        # this rank's rows of the node axis (all of them off a mesh) and
        # its words of the bitset (all of them without a words axis)
        block = n // node_shards(mesh)
        self._rows = slice(node_index(mesh) * block,
                           (node_index(mesh) + 1) * block)
        wb = self.n_words // n_wsh
        self._wcols = slice(word_index(mesh) * wb,
                            (word_index(mesh) + 1) * wb)
        self._base_once = word_index(mesh) == 0
        # the all-axes sum of the ledgers and popcounts (mode-aware)
        self._psum = dcn_psum(mesh, self._dcn)
        self.deg = torch.as_tensor(self._host_deg[self._rows],
                                   device=self.device)
        self.sharded_exchange = (None if sharded_exchange is None
                                 else sharded_exchange.bind(mesh)
                                 if mesh is not None else sharded_exchange)
        self.sharded_sync_diff = (None if sharded_sync_diff is None
                                  else sharded_sync_diff.bind(mesh)
                                  if mesh is not None
                                  else sharded_sync_diff)
        self._shard = ONE_DEVICE
        self._row0 = self._rows.start
        if self.words_major:
            f = self._faulted
            delay_bundle = delayed if delayed is not None else edge_delayed
            halo = mesh is None
            if mesh is not None:
                # the bundle that delivers decides: its halo closure, or
                # the all-gather fallback (which the delay modes refuse)
                lead = next((b for b in (nemesis, delay_bundle, f)
                             if b is not None), None)
                halo = (lead.sharded_exchange if lead is not None
                        else self.sharded_exchange) is not None
                if delay_bundle is not None and not halo:
                    what = "delayed" if delayed is not None \
                        else "edge-delayed"
                    raise ValueError(
                        f"{what} structured delivery on a mesh needs the "
                        "halo closure (no all_gather fallback)")
            if f is not None:
                # the halo path masks the local block: its rows' bits
                cut = self._rows if mesh is not None and halo \
                    else slice(None)
                self._fx_exists = kernels.pack_bits(
                    torch.from_numpy(f.exists[..., cut])).to(self.device)
                self._fx_same = kernels.pack_bits(
                    torch.from_numpy(f.same[..., cut])).to(self.device)
            bundle = nemesis if nemesis is not None else f
            if mesh is not None:
                # the reference's gates: the halo closures, else no ledger
                self._srv_on = srv_ledger and halo and (
                    bundle.sharded_sync_diff if bundle is not None
                    else self.sharded_sync_diff) is not None
                sync_diff = self.sharded_sync_diff
            elif bundle is not None:
                self._srv_on = srv_ledger and bundle.sync_diff is not None
            else:
                self._srv_on = srv_ledger and sync_diff is not None
            self._wm_exchange = exchange
            if mesh is not None and halo:
                if f is not None:
                    f = self._faulted = dataclasses.replace(
                        f, exchange=f.sharded_exchange.bind(mesh),
                        sync_diff=f.sharded_sync_diff.bind(mesh))
                # outside the windows: the sim's halo exchange, or the
                # bundle's masked one under the exists rows (the delay
                # and nemesis rounds deliver through their own closures)
                self._wm_exchange = (
                    self.sharded_exchange if f is None
                    or self.sharded_exchange is not None else
                    (lambda p, f=f, ex=self._fx_exists: f.exchange(p, ex)))
                self._shard = Shard(reduce_sum=self._psum,
                                    base_once=self._base_once)
            elif mesh is not None:
                self._shard = Shard(
                    reduce_sum=self._psum,
                    widen=lambda p: mesh.all_gather(p, dim=1),
                    rows=self._rows, base_once=self._base_once)
            self._halo = halo
            if f is not None and sync_diff is None:
                # outside the windows: the bundle's diff under exists
                def sync_diff(r, f=f, ex=self._fx_exists):
                    return f.sync_diff(r, ex)
            self.sync_diff = sync_diff
            # the structured path never reads the adjacency on device
            self.nbrs = self.nbr_mask = self.row_ids = None
        else:
            self.sync_diff = None
            self._srv_on = srv_ledger
            self.nbrs = torch.as_tensor(
                np.ascontiguousarray(np.asarray(nbrs, np.int32)[self._rows]),
                device=self.device)
            self.nbr_mask = self.nbrs >= 0
            self.row_ids = torch.arange(self._rows.start, self._rows.stop,
                                        device=self.device)
            if mesh is not None:
                # under a plan the coins' liveness operand covers every
                # node
                self._shard = Shard(
                    reduce_sum=self._psum,
                    widen=lambda p: mesh.all_gather(p, dim=0),
                    row0=self._row0, base_once=self._base_once,
                    all_ids=None if fault_plan is None else torch.arange(
                        n, device=self.device))
        if nemesis is not None:
            self._setup_nemesis(nemesis)
        self._setup_delays(delays, delayed, edge_delayed, nemesis)
        self._fp_dup = fault_plan is not None and fault_plan.dup_num > 0
        self._ub = None
        self.fault_plan = None
        if fault_plan is not None:
            if fault_plan.n_nodes != n:
                raise ValueError(f"FaultPlan is for {fault_plan.n_nodes} "
                                 f"nodes, sim has {n}")
            # loss and crash keep the reference's calibrated accounting;
            # a dup stream re-delivers whole received sets while the
            # reference dedups by message id, so it cannot be calibrated
            if self._fp_dup and self._srv_on:
                raise ValueError(
                    "srv ledger under a dup stream: a dup edge "
                    "re-delivers its source's whole received set "
                    "while the reference dedups by message id, so "
                    "the server ledgers cannot be calibrated (the "
                    "kvstore backend's reject_dup_stream stance) — "
                    "pass srv_ledger=False and read the `msgs` value "
                    "ledger instead")
            self.fault_plan = fault_plan.to(self.device)
            if self.words_major:
                # the bundle's degree-contract coin rows have no crash
                # liveness decomposition: the words-major ledger keeps
                # the loss-only accounting and goes off for a crash plan,
                # and for dir_delays
                self._srv_on = (self._srv_on and not fault_plan.starts
                                and nemesis.dir_delays is None)
            elif delays is not None:
                # the ring's current-state sync diff holds only per wave:
                # a delayed run keeps no ledger under a plan
                self._srv_on = False
            else:
                # per destination row: D edges x (liveness + loss/dup
                # coins + gather temps), about 16 bytes per edge slot; a
                # rank's slabs cut its own rows
                self._ub = resolve_block(block, union_block,
                                         per_row_bytes=nbrs.shape[1] * 16)
            if self._ub is not None and self._srv_on:
                if union_block is not None:
                    raise ValueError(
                        "blocked faulted gather rounds keep no srv "
                        "ledger: pass srv_ledger=False (or "
                        "union_block='materialized' to keep the "
                        "loss-only ledger on the materialized path)")
                # an env-chosen block yields to the ledger the caller
                # asked for
                self._ub = None
        self._fixed = {}
        self._traffic = {}

    def _setup_nemesis(self, nem) -> None:
        """The nemesis round's operand and closures on this sim: the whole
        mask operand off a mesh and on the all-gather fallback (with the
        widen / slice closures), a rank's block of it with the bundle's
        halo closures bound on the halo path."""
        mesh, rows = self.mesh, self._rows
        arrs = nem.arrs
        self._nem_shard = ONE_DEVICE
        if mesh is not None and self._halo:
            arrs = arrs.shard(node_index(mesh), node_shards(mesh))
            nem = dataclasses.replace(
                nem, exchange=nem.sharded_exchange.bind(mesh),
                src_pc=nem.sharded_src_pc.bind(mesh),
                sync_diff=nem.sharded_sync_diff.bind(mesh),
                ring_exchange=None if nem.sharded_ring_exchange is None
                else nem.sharded_ring_exchange.bind(mesh))
            self._nem_shard = Shard(reduce_sum=self._psum,
                                    base_once=self._base_once)
        elif mesh is not None:
            self._nem_shard = Shard(
                reduce_sum=self._psum,
                widen=lambda p: mesh.all_gather(p, dim=1), rows=rows,
                base_once=self._base_once)
        self._nem = nem
        self._nem_arrs = arrs.to(self.device)
        self._nem_deg = kernels.count_rows(self._nem_arrs.deg_exists,
                                           self._nem_arrs.n_nodes)

    def _setup_delays(self, delays, delayed, edge_delayed, nemesis) -> None:
        """The delay mode's ring length, its device operands and its
        delivery closure ``self._delayed_ex(history, t)`` (None for the
        gather path's delays and the nemesis, which their rounds take).
        On a mesh the closure is the bundle's halo twin over the rank's
        block of the ring, its class rows and window masks cut to the
        block's columns."""
        self._classes = None
        self._delayed_ex = None
        self.ring = 1
        mesh = self.mesh
        cols = self._rows if mesh is not None else slice(None)
        if delays is not None:
            # every rank takes the classes of the whole table, so that the
            # ranks' rounds make the same collectives
            d = np.asarray(delays, np.int32)
            self._classes = delay_classes(
                torch.as_tensor(np.ascontiguousarray(d[self._rows]),
                                device=self.device),
                tuple(int(v) for v in np.unique(d)))
            self.ring = max(self._classes)
        elif delayed is not None:
            self.ring = delayed.ring
            ex = (delayed.exchange if mesh is None
                  else delayed.sharded_exchange.bind(mesh))
            if hasattr(delayed, "same"):
                self._delayed_ex = lambda h, t: ex(h, t, self._live_at)
            else:
                self._delayed_ex = ex
        elif edge_delayed is not None:
            ed = edge_delayed
            self.ring = ed.ring
            rows = ed.class_rows(self.device, cols)
            ex = (ed.exchange if mesh is None
                  else ed.sharded_exchange.bind(mesh))
            if hasattr(ed, "del_same"):
                dsame = kernels.pack_bits(torch.from_numpy(
                    np.ascontiguousarray(ed.del_same[..., cols]))).to(
                        self.device)
                ps, pe = self.parts.starts, self.parts.ends
                self._delayed_ex = lambda h, t: ex(
                    h, t, rows, ed.live_by_delay(dsame, ps, pe, t))
            else:
                self._delayed_ex = lambda h, t: ex(h, t, rows)
        elif nemesis is not None and nemesis.dir_delays is not None:
            self.ring = nemesis.ring
        self._delay_mode = (delays is not None or delayed is not None
                            or edge_delayed is not None
                            or (nemesis is not None
                                and nemesis.dir_delays is not None))

    # -- construction ----------------------------------------------------

    def init_state(self, inject: np.ndarray) -> BroadcastState:
        """The round-0 state of the (N, W) uint32 injection (this rank's
        block of it on a mesh: its rows, and its words on a words
        mesh)."""
        local = np.asarray(inject, np.uint32)[self._rows, self._wcols]
        received = _bits_from_numpy(local, self.words_major).to(
            self.device)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        history = None
        if self._delay_mode:
            history = torch.zeros((self.ring,) + tuple(received.shape),
                                  dtype=torch.int32, device=self.device)
        return BroadcastState(received=received, frontier=received.clone(),
                              t=0, msgs=zero,
                              srv_msgs=zero.clone() if self._srv_on
                              else None, history=history)

    def target_bits(self, inject: np.ndarray) -> torch.Tensor:
        """(W,) int32 — union of all injected values: the convergence
        target every node must reach (this rank's words of it on a words
        mesh)."""
        union = np.bitwise_or.reduce(np.asarray(inject, np.uint32), axis=0)
        return torch.from_numpy(np.ascontiguousarray(
            union[self._wcols]).view(np.int32)).to(self.device)

    def stage(self, inject: np.ndarray
              ) -> tuple[BroadcastState, torch.Tensor]:
        """(initial state, convergence target), both on the device."""
        return self.init_state(inject), self.target_bits(inject)

    # -- drivers ---------------------------------------------------------

    def _live_rows(self, t: int) -> torch.Tensor | None:
        """(D, ceil(N/32)) packed per-direction liveness of round ``t``
        under the partition schedule: exists AND same-group under every
        active window (the per-direction form of :func:`_edge_live`);
        None when no window is active."""
        if self._faulted is None or not self.parts.active(t):
            return None
        return self._live_at(t)

    def _live_at(self, t: int) -> torch.Tensor:
        """:meth:`_live_rows` of round ``t``, the exists rows themselves
        when no window is active."""
        same = self._fx_same
        return windows_fold(self.parts.starts, self.parts.ends, t,
                            lambda w, lv: lv & same[w], self._fx_exists)

    def step(self, state: BroadcastState) -> BroadcastState:
        if self._nem is not None:
            return _round_wm_nem(state, nem=self._nem, arrs=self._nem_arrs,
                                 plan=self.fault_plan, parts=self.parts,
                                 sync_every=self.sync_every,
                                 dup_on=self._fp_dup, deg_topo=self._nem_deg,
                                 shard=self._nem_shard)
        if self.words_major:
            return _round_wm(state, deg=self.deg,
                             sync_every=self.sync_every,
                             exchange=self._wm_exchange,
                             sync_diff=self.sync_diff if self._srv_on
                             else None,
                             live=self._live_rows(state.t),
                             faulted=self._faulted,
                             delayed_exchange=self._delayed_ex,
                             shard=self._shard)
        return _round(state, row_ids=self.row_ids, nbrs=self.nbrs,
                      nbr_mask=self.nbr_mask, parts=self.parts,
                      sync_every=self.sync_every, deg=self.deg,
                      plan=self.fault_plan, dup_on=self._fp_dup,
                      union_block=self._ub, classes=self._classes,
                      shard=self._shard)

    def converged(self, state: BroadcastState,
                  target: torch.Tensor) -> bool:
        """Every node holds ``target``: on a mesh every rank's block,
        agreed over the mesh (every rank gets the same answer)."""
        t = target[:, None] if self.words_major else target[None, :]
        ok = bool((state.received == t).all())
        return ok if self.mesh is None else self.mesh.agree(ok)

    def run(self, inject: np.ndarray, *, max_rounds: int = 1 << 16,
            check_every: int = 1) -> tuple[BroadcastState, int]:
        """Step until every node holds every injected value (or
        ``max_rounds``); runs at least one round.  Returns (final state,
        rounds run)."""
        target = self.target_bits(inject)
        return stepwise_converge(
            self.step, lambda s: self.converged(s, target),
            self.init_state(inject), max_rounds, check_every)

    def run_staged(self, state: BroadcastState, target: torch.Tensor, *,
                   max_rounds: int = 1 << 16,
                   donate: bool = False) -> BroadcastState:
        """The while-converge run on a staged (state, target) pair from
        :meth:`stage`: convergence is tested before the first round and
        after each, until ``state.t`` reaches ``max_rounds``.  The rounds
        are out of place, so the staged state stays reusable whatever
        ``donate`` (the reference's argument) says."""
        return while_converge(self.step,
                              lambda s: self.converged(s, target), state,
                              max_rounds)

    def run_fused(self, inject: np.ndarray, *, max_rounds: int = 1 << 16,
                  ) -> tuple[BroadcastState, int]:
        """:meth:`run_staged` on a freshly staged workload.  Returns
        (final state, rounds run)."""
        state, target = self.stage(inject)
        final = self.run_staged(state, target, max_rounds=max_rounds,
                                donate=True)
        return final, final.t

    def _build_fixed(self, rounds: int, donate: bool):
        """(runner, flood parts | None) for exactly ``rounds`` rounds.
        The pure-flood specialization (kernel loop + closed-form ledger)
        applies on the words-major path when no sync wave fires within
        the trip count, the server ledger is off and no fault or delay
        mode is on (no partition bundle, no plan, no ring) — the
        reference's ``flood_ok`` gate.  The gather path has none (the
        reference's gate needs the words-major layout)."""
        flood_ok = (self.words_major and not self._srv_on
                    and self._faulted is None and self.fault_plan is None
                    and not self._delay_mode
                    and 0 < rounds <= self.sync_every
                    and (self.mesh is None
                         or self.sharded_exchange is not None))
        if not flood_ok:
            def run(state: BroadcastState) -> BroadcastState:
                return fori_rounds(self.step, state, rounds)
            return run, None

        degs, masks = _degree_masks(self._host_deg[self._rows], self.device)
        flood = _flood_loop(self.exchange if self.mesh is None
                            else self.sharded_exchange, rounds)

        def loop_fn(rec: torch.Tensor, fr: torch.Tensor):
            if not donate:
                rec, fr = rec.clone(), fr.clone()
            return flood(rec, fr)

        def finish(state0: BroadcastState, loop_out) -> BroadcastState:
            return _flood_ledger(state0, *loop_out, degs, masks, rounds,
                                 self._psum)

        def composed(state: BroadcastState) -> BroadcastState:
            return finish(state, loop_fn(state.received, state.frontier))

        return composed, (loop_fn, finish)

    def build_fixed(self, rounds: int, *, donate: bool = False):
        """Build (and cache) the fixed-trip runner for ``rounds``.
        Returns the phase-split handles ``(loop_fn, finish)`` when the
        pure-flood specialization applies (loop_fn: (received, frontier)
        -> (received, frontier); finish: (state0, loop_out) -> final
        state), else None.  With ``donate`` the loop consumes its inputs
        (received is updated in place); callers re-stage per run."""
        key = (rounds, donate)
        if key not in self._fixed:
            self._fixed[key] = self._build_fixed(rounds, donate)
        return self._fixed[key][1]

    def run_staged_fixed(self, state: BroadcastState, rounds: int, *,
                         donate: bool = False) -> BroadcastState:
        """Exactly ``rounds`` rounds; equal to :meth:`run_fused` when
        ``rounds`` is that run's convergence round count.  With
        ``donate`` the state is consumed."""
        self.build_fixed(rounds, donate=donate)
        return self._fixed[(rounds, donate)][0](state)

    # -- open-loop traffic -----------------------------------------------

    def _traffic_validate(self, tspec) -> None:
        if self._wcols != slice(0, self.n_words):
            raise ValueError(
                "the traffic drivers run on node meshes: a client's value "
                "bits live in one word shard, so a 'words' mesh refuses "
                "them, as the reference's does")
        if self.mesh is not None and tspec.n_clients % node_shards(self.mesh):
            raise ValueError(
                f"n_clients={tspec.n_clients} must shard evenly over the "
                "node axis")
        if self._srv_on:
            raise ValueError(
                "traffic drivers keep no server ledger (open-loop "
                "ops have no reference srv accounting): build the "
                "sim with srv_ledger=False")
        need = tspec.n_clients * tspec.ops_per_client
        if need > self.n_values:
            raise ValueError(
                f"value universe too small: n_values={self.n_values} "
                f"< n_clients*ops_per_client={need} (every op is its "
                "own value bit)")

    def _traffic_index(self, tspec) -> dict:
        """The traffic driver's per-spec index tensors
        (:func:`.traffic.client_index` and each op's value word and bit
        position), cached by the spec's static key."""
        key = tspec.program_key
        if key not in self._traffic:
            self._traffic_validate(tspec)
            ix = traffic.client_index(tspec, self.n_nodes, self.device,
                                      self.mesh)
            v = (ix["ids"][:, None] * tspec.ops_per_client
                 + torch.arange(tspec.ops_per_client,
                                device=self.device)[None, :])
            ix.update(v_word=v // WORD, v_shift=(v % WORD).to(torch.int32))
            self._traffic[key] = ix
        return self._traffic[key]

    def _traffic_inject(self, state: BroadcastState, ts, tspec, tplan,
                        ix: dict):
        """Fold this round's arrivals into the node rows, in place: op
        (client, k) is value bit ``client * ops_per_client + k``, added at
        the client's home node to ``received`` and ``frontier`` (a sum of
        distinct new bits is their OR, whatever order the card adds them
        in; a deferred arrival adds 0 to word 0).  Deferral classes — home node down, the ``intake`` cap, op
        slots exhausted — are counted by :func:`.traffic.issue`."""
        t, node = state.t, ix["node"]
        arr = traffic.arrive(tplan, t, ix["ids"])
        plan = self.fault_plan
        accept = (faults.node_up(plan, t, ix["node_ids"]) if plan is not None
                  else torch.ones_like(arr))
        if tspec.intake is not None:
            accept = accept & (
                traffic.intake_rank(arr, tspec.clients_per_node)
                < tspec.intake)
        ts, ok, kslot = traffic.issue(ts, arr, accept, t, self._sum())
        v = ix["ids"] * tspec.ops_per_client + kslot
        w = torch.where(ok, v // WORD, 0)
        bit = kernels._wrap_i32(torch.where(ok, 1 << (v % WORD), 0))
        # the home rows lie in this rank's block of the node axis
        rows = self._rows.stop - self._rows.start
        at = (w * rows + node if self.words_major
              else node * self.n_words + w)
        state.received.view(-1).index_add_(0, at, bit)
        state.frontier.view(-1).index_add_(0, at, bit)
        return state, ts

    def _traffic_done(self, s2: BroadcastState, ts, tspec, ix: dict):
        """Per-op visibility: the op's value bit at every node, read from
        the all-nodes words (:func:`.kernels.and_fold`)."""
        all_words = kernels.and_fold(s2.received,
                                     node_major=not self.words_major)
        if self.mesh is not None:
            # the rank's fold, then the AND over the ranks (a ppermute
            # circuit: no all-gather)
            all_words = self._coll().reduce_and(all_words)

        def bit_fn(lo, block):
            sl = slice(lo, lo + block)
            return ((all_words[ix["v_word"][sl]] >> ix["v_shift"][sl])
                    & 1) > 0

        return traffic.done_scan(ts, bit_fn, s2.t, ix["block"], self._sum())

    def _sum(self):
        """The mesh's all-reduce sum (None off a mesh)."""
        return None if self.mesh is None else self._psum

    def _coll(self):
        """The engine's collectives over this rank's block (a mesh), made
        once."""
        if "_collectives" not in self.__dict__:
            from .engine import collectives

            self._collectives = collectives(
                self._rows.stop - self._rows.start, self.mesh)
        return self._collectives

    def _popcount_part(self, x: torch.Tensor) -> torch.Tensor:
        """() int64: the set bits of this rank's block of a bitset in the
        sim's layout (:func:`.kernels.col_popcount`)."""
        return kernels.col_popcount(
            x, node_major=not self.words_major).sum(dtype=torch.int64)

    def _popcount(self, x: torch.Tensor) -> torch.Tensor:
        """() int64: the set bits of a bitset in the sim's layout, over the
        whole mesh."""
        return self._psum(self._popcount_part(x))

    def _tel_series(self, t: int, fr0_pc, s1: BroadcastState,
                    mask) -> tuple:
        """Round ``t``'s telemetry row (``telemetry.SIM_SERIES
        ['broadcast']``): liveness, the popcount of the frontier that
        went out (``fr0_pc``, taken before the round), of the new
        frontier and of ``received``, the value-message total; only the
        columns ``mask`` keeps.  The popcounts are a rank's partials
        (:meth:`_record` sums them)."""
        live, _fr0, new, known, _msgs = mask
        return (telemetry.live_count(self.fault_plan, t, self.n_nodes)
                if live else None, fr0_pc,
                self._popcount_part(s1.frontier) if new else None,
                self._popcount_part(s1.received) if known else None, s1.msgs)

    def _record(self, tel, t: int, vals, mask, extra=()):
        """:func:`.telemetry.record` of a row, its partial columns (the
        popcounts, and ``extra``'s) summed over a mesh in one call."""
        partial = (False, True, True, True, False) + tuple(extra)
        return telemetry.record(tel, t, vals, mask, partial, self._sum())

    def traffic_state(self, tspec) -> "traffic.TrafficState":
        """An empty tracker (a rank's block of the clients on a mesh)."""
        return traffic.init_state(tspec, self.mesh, device=self.device)

    def run_traffic(self, state: BroadcastState, ts, tspec,
                    n_rounds: int, *, donate: bool = False,
                    tel=None, tel_spec=None):
        """Open-loop serving driver: ``n_rounds`` rounds, each injecting
        the spec's seeded client arrivals (new values at their home
        nodes) before the round (:meth:`step`: any layout, fault or delay
        mode) and advancing the per-op latency tracker after it
        (:mod:`.traffic`).  With ``donate`` the state, the tracker and
        the ring are consumed (updated in place); else they are copied
        first.  ``tel`` / ``tel_spec``: record the per-round telemetry
        ring too, and return ``(state, ts, tel)``."""
        telemetry.tel_key(tel, tel_spec, "broadcast")
        ix = self._traffic_index(tspec)
        tplan = tspec.compile()
        if not donate:
            state = dataclasses.replace(
                state, received=state.received.clone(),
                frontier=state.frontier.clone())
            ts = ts.clone()
            tel = None if tel is None else tel.clone()
        mask = None if tel is None else tel_spec.static_mask
        for _ in range(n_rounds):
            t = state.t
            state, ts = self._traffic_inject(state, ts, tspec, tplan, ix)
            # the frontier this round floods, arrivals included
            fr0_pc = (self._popcount_part(state.frontier)
                      if tel is not None and mask[1] else None)
            state = self.step(state)
            ts = self._traffic_done(state, ts, tspec, ix)
            if tel is not None:
                vals = (self._tel_series(t, fr0_pc, state, mask[:5])
                        + traffic.tel_series(ts))
                tel = self._record(tel, t, vals, mask,
                                   traffic.TRAFFIC_PARTIAL)
        return (state, ts) if tel is None else (state, ts, tel)

    # -- observed runs: the telemetry ring and the provenance record -------

    def telemetry_state(self, tspec) -> "telemetry.TelemetryState":
        return telemetry.init_state(tspec, device=self.device)

    def provenance_state(self, pspec, inject) -> "provenance.BroadcastProv":
        """A fresh (N, V) provenance record on the sim's device, the origin
        cells stamped from the round-0 ``inject`` bitset (on a mesh this
        rank's rows of it, :func:`.provenance.broadcast_specs`)."""
        rows = self._rows
        return provenance.init_broadcast(
            rows.stop - rows.start, self.n_values,
            np.asarray(inject, np.uint32)[rows], device=self.device)

    def _observed_check(self, tspec, pspec) -> None:
        """The reference's refusals of the observed driver: telemetry
        rides the gather path (one hop and per-edge delays) and the
        words-major one-hop path, provenance the gather path only."""
        if tspec is None and pspec is None:
            raise ValueError(
                "observed drivers need a TelemetrySpec and/or a "
                "ProvenanceSpec")
        if tspec is not None and (tspec.workload != "broadcast"
                                  or tspec.traffic):
            raise ValueError(
                "run_observed needs a TelemetrySpec(workload="
                "'broadcast', traffic=False); open-loop runs record "
                "through run_traffic(tel=...)")
        if pspec is not None and self.words_major:
            raise ValueError(
                "broadcast provenance rides the gather path (the "
                "structured words-major exchanges fold their direction "
                "terms internally — see tpu_sim/provenance.py); drop "
                "exchange= for a provenance-on run")
        if pspec is not None and self.mesh is not None \
                and "words" in self.mesh.axis_names:
            raise ValueError(
                "broadcast provenance runs on 1-D node meshes (the "
                "(N, V) stamps shard with the node axis only)")
        if self.words_major and self._delay_mode:
            raise ValueError(
                "observed drivers run the gather (1-hop and per-edge "
                "delays) and 1-hop words-major paths; words-major "
                "delay-ring modes are not wired")

    def run_observed(self, state: BroadcastState, tel, tspec, n_rounds: int,
                     *, donate: bool = False, prov=None, prov_spec=None):
        """``n_rounds`` rounds of :meth:`step` with the per-round telemetry
        ring (``tel`` / ``tspec``, a ``TelemetrySpec(traffic=False)``)
        and / or the provenance record (``prov`` / ``prov_spec``, gather
        path: the round runs materialized and stamps it) recorded beside
        the state, which they only read: the state equals the plain
        drivers' bit for bit.  With ``donate`` the ring and the record
        are updated in place, else copied first (the rounds never change
        the state passed in).  Returns ``(state, tel?, prov?)``, the
        leaves that were passed, in order.  On a mesh the record is the
        rank's rows (:meth:`provenance_state`)."""
        if (tel is None) != (tspec is None):
            raise ValueError(
                "pass tel and tel_spec together (build the ring with "
                "telemetry.init_state(spec))")
        provenance.prov_key(prov, prov_spec, "broadcast")
        self._observed_check(tspec, prov_spec)
        if not donate:
            tel = None if tel is None else tel.clone()
            prov = None if prov is None else provenance.BroadcastProv(
                *(x.clone() for x in prov))
        mask = None if tel is None else tspec.static_mask
        for _ in range(n_rounds):
            t = state.t
            fr0_pc = (self._popcount_part(state.frontier)
                      if tel is not None and mask[1] else None)
            if prov is None:
                state = self.step(state)
            else:
                state, prov = _round(
                    state, row_ids=self.row_ids, nbrs=self.nbrs,
                    nbr_mask=self.nbr_mask, parts=self.parts,
                    sync_every=self.sync_every, deg=self.deg,
                    plan=self.fault_plan, dup_on=self._fp_dup,
                    union_block=None, classes=self._classes, prov=prov,
                    shard=self._shard)
            if tel is not None:
                tel = self._record(
                    tel, t, self._tel_series(t, fr0_pc, state, mask), mask)
        return ((state,) + (() if tel is None else (tel,))
                + (() if prov is None else (prov,)))

    # -- readout ---------------------------------------------------------

    def received_node_major(self, state: BroadcastState) -> np.ndarray:
        """(N, W) uint32 received bitset (on a mesh every rank's block,
        gathered on every rank: along the node axis, then the words)."""
        rec = state.received
        if self.mesh is not None:
            rec = self.mesh.all_gather(rec, dim=1 if self.words_major
                                       else 0)
            if self._wcols != slice(0, self.n_words):
                rec = self.mesh.all_gather(
                    rec, dim=0 if self.words_major else 1, axis="words")
        return _bits_to_numpy(rec, self.words_major)

    def inject_mid(self, state: BroadcastState, node: int,
                   value: int) -> BroadcastState:
        """A client broadcast mid-run: ``value`` set at ``node`` (received
        and frontier), so the next round floods it, out of place.  The
        server ledger, where it is on, takes the origin's correction: one
        send and one ack more than the learner the next round charges it
        as.  The gather path only, as in the reference.  On a mesh the
        rank whose block holds the node (and the value's word) sets it;
        every rank takes the ledger's correction."""
        if self.words_major:
            raise ValueError("inject_mid targets the gather path")
        w, b = value // WORD, 1 << (value % WORD)
        bit = b - (1 << 32) if b >= 1 << 31 else b
        received, frontier = state.received.clone(), state.frontier.clone()
        rows, cols = self._rows, self._wcols
        if rows.start <= node < rows.stop and cols.start <= w < cols.stop:
            received[node - rows.start, w - cols.start] |= bit
            frontier[node - rows.start, w - cols.start] |= bit
        srv = (None if state.srv_msgs is None
               else (state.srv_msgs + 2) & MASK32)
        return dataclasses.replace(state, received=received,
                                   frontier=frontier, srv_msgs=srv)

    def run_stats(self, inject: np.ndarray, *, max_rounds: int = 1 << 16,
                  ) -> tuple[BroadcastState, int, list[dict]]:
        """:meth:`run` with a record a round: the round, the bits known
        over all nodes (a uint32 sum, as the reference's), the messages
        of the round and in total.  Returns (final state, rounds run,
        records)."""
        target = self.target_bits(inject)
        state = self.init_state(inject)
        stats: list[dict] = []
        prev_msgs = 0
        rounds = 0
        while rounds < max_rounds:
            state = self.step(state)
            rounds += 1
            known = int(self._popcount(state.received)) & MASK32
            msgs = int(state.msgs)
            stats.append({"round": rounds, "known_bits": known,
                          "msgs_round": msgs - prev_msgs,
                          "msgs_total": msgs})
            prev_msgs = msgs
            if self.converged(state, target):
                break
        return state, rounds, stats

    def read(self, state: BroadcastState) -> list[list[int]]:
        """Each node's sorted value list (the ``read`` handler's reply),
        on the host."""
        rec = self.received_node_major(state)
        bits = np.unpackbits(rec.astype("<u4").view(np.uint8), axis=1,
                             bitorder="little")
        return [np.flatnonzero(row).tolist() for row in bits]

    def server_msgs(self, state: BroadcastState) -> int:
        """Reference-accounted server-to-server message total."""
        if state.srv_msgs is None:
            raise ValueError(
                "server-message ledger is off: srv_ledger=False, a "
                "words-major run without its sync_diff closure "
                "(structured.make_sync_diff), or a words-major FaultPlan "
                "beyond the loss-only regime (the nemesis bundle's coin "
                "rows have no crash liveness decomposition; dup streams "
                "reject at construction)")
        return int(state.srv_msgs)


# -- the scenario batch, folded (tpu_sim/scenario.py) --------------------
#
# S broadcast scenarios over one adjacency run as ONE graph of S N node
# rows: scenario s's rows are [s N, (s + 1) N), its neighbor indices are
# offset by s N (the -1 pads stay -1), and every fault operand is batched
# (a faults.BatchPlan, a (S, P) partition schedule, per-scenario delays).
# A round is then the faulted gather round of the sequential runner over
# the folded rows: one batched fault_coins and one faulted_gather_round
# whatever S is (a delayed round: one batched fault_coins, one more a delay
# class for its send round's liveness, one gather_or a class).  Every
# scenario's coins hash its own ids and its rows read only its own rows, so
# each scenario evolves exactly as its one-scenario run.  Scenarios share
# the round counter: an active scenario is at round t = the trip's
# iteration, a frozen one keeps its rows (a torch.where over them).


@dataclasses.dataclass
class BatchState:
    """A folded batch's carry: the bitsets of S scenarios of N rows each,
    node-major (S N, W) int32, the (S,) int64 uint32 ledgers, the (L, S N,
    W) payload ring of the delay modes (None for one hop)."""

    received: torch.Tensor
    frontier: torch.Tensor
    msgs: torch.Tensor
    history: torch.Tensor | None = None


class FoldedBatch:
    """The operands of a folded scenario batch on one device and its
    round.  ``nbrs``: the shared (N, D) table padded with -1; ``plan``: a
    :class:`.faults.BatchPlan`; ``pstarts`` / ``pends`` (S, P) host arrays
    and ``group`` (S, P, N) int8 the padded partition schedules; ``delays``
    (S, N, D) per-edge delays (None: one hop) over the batch's
    ``delay_set``; ``rounds`` the trip count (the coin table's and the
    window flags' length)."""

    def __init__(self, nbrs: np.ndarray, *, plan: faults.BatchPlan,
                 pstarts: np.ndarray, pends: np.ndarray,
                 group: torch.Tensor, sync_every: int, rounds: int,
                 delays: np.ndarray | None = None, delay_set: tuple = (),
                 device=None) -> None:
        dev = resolve_device(device)
        s, n = plan.n_scenarios, plan.n_nodes
        nb = np.asarray(nbrs, np.int64)
        off = (np.arange(s, dtype=np.int64) * n)[:, None, None]
        fold = np.where(nb[None] >= 0, nb[None] + off, -1)
        # each edge's source row clipped into its own scenario (the
        # sequential clip into [0, N), a pad to the scenario's row 0)
        src = np.where(nb[None] >= 0, nb[None], 0) + off
        self.s_count, self.n = s, n
        self.device = dev
        self.nbrs = torch.from_numpy(
            fold.reshape(s * n, -1).astype(np.int32)).to(dev)
        self.nbr_mask = self.nbrs >= 0
        self.src = torch.from_numpy(src.reshape(s * n, -1)).to(dev)
        self.plan = plan.to(dev)
        self.sync_every = sync_every
        self.wflags = plan.window_flags(rounds, dev)
        self.table = plan.coin_table(rounds, dev)
        self.table_nodup = self.table.clone()
        self.table_nodup[..., 4] = 0
        self.pstarts, self.pends = pstarts, pends
        t = np.arange(-1, rounds)[:, None, None]
        self.pact_host = (pstarts[None] <= t) & (t < pends[None])
        self.pflags = torch.from_numpy(self.pact_host).to(dev)
        self.group = group.to(dev).transpose(0, 1).reshape(
            group.shape[1], s * n)                 # (P, S N)
        self.classes, self.ring = None, 0
        if delays is not None:
            d = torch.from_numpy(np.asarray(delays, np.int32).reshape(
                s * n, -1)).to(dev)
            self.classes = delay_classes(d, delay_set)
            self.ring = max(self.classes)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """An (S,) or (S, N) per-scenario tensor as (S N, 1) rows."""
        if x.dim() == 1:
            x = x[:, None].expand(self.s_count, self.n)
        return x.reshape(-1, 1)

    def segment_sum(self, x: torch.Tensor) -> torch.Tensor:
        """(S,) int64: the per-scenario sums of an (S N,) tensor."""
        return x.to(torch.int64).view(self.s_count, self.n).sum(dim=1)

    def popcounts(self, x: torch.Tensor) -> torch.Tensor:
        """(S,) int64: each scenario's set bits of a folded bitset."""
        return self.segment_sum(kernels.col_popcount(x, node_major=True))

    def init_state(self, injs: np.ndarray) -> BatchState:
        """The batch's round-0 state from the (S, N, W) uint32 injections."""
        s, n = self.s_count, self.n
        rec = torch.from_numpy(np.ascontiguousarray(
            np.asarray(injs, np.uint32).reshape(s * n, -1)).view(
                np.int32)).to(self.device)
        hist = (torch.zeros((self.ring,) + tuple(rec.shape),
                            dtype=torch.int32, device=self.device)
                if self.classes is not None else None)
        return BatchState(received=rec, frontier=rec.clone(),
                          msgs=torch.zeros(s, dtype=torch.int64,
                                           device=self.device),
                          history=hist)

    def up(self, t: int) -> torch.Tensor:
        """(S N,) bool: the rows up at round ``t``."""
        return self.plan.up(self.wflags, t).reshape(-1)

    def edge_live(self, t: int) -> torch.Tensor | None:
        """(S N, D) bool delivering edges at round ``t`` under each
        scenario's partition windows (one pass a window index), or None
        when no scenario has a window active."""
        act = self.pact_host[t + 1]
        if not act.any():
            return None
        live = self.nbr_mask
        for p in range(act.shape[1]):
            if not act[:, p].any():
                continue
            g = self.group[p]
            same = g[:, None] == g[self.src]
            live = live & (same | ~self.rows(self.pflags[t + 1][:, p]))
        return live

    def _live_del_at(self, t: int) -> torch.Tensor:
        """(S N, D) bool: the edges that deliver a message sent at round
        ``t`` (the sequential :func:`_live_del_at`): topology, partition
        windows, both endpoints up and the loss coin kept."""
        live = self.edge_live(t)
        flags = kernels.fault_coins(
            self.nbrs, self.up(t), t=t,
            live=self.nbr_mask if live is None else live,
            table=self.table_nodup[t], block=self.n)
        return (flags & FLAG_DEL) != 0

    def round(self, st: BatchState, t: int,
              active: torch.Tensor) -> tuple[BatchState, torch.Tensor]:
        """Round ``t`` of every scenario, frozen where ``active`` ((S,)
        bool) is False: the state's bitsets and ring slot are updated in
        place (:func:`.kernels.fold_freeze`, a frozen scenario's rows
        kept).  Returns ``(state, up)``, ``up`` the (S N,) rows up at
        ``t`` (the telemetry's liveness)."""
        wipe = self.rows(self.plan.amnesia(self.wflags, t))
        rec0 = st.received.masked_fill(wipe, 0)
        fr0 = st.frontier.masked_fill(wipe, 0)
        payload = rec0 if _is_sync(t, self.sync_every) else fr0
        up = self.up(t)
        dup_rows = rec0 if self.plan.any_dup(t) else None
        pc = kernels.col_popcount(payload, node_major=True).to(torch.int64)
        flags = kernels.fault_coins(self.nbrs, up, t=t,
                                    live=self.edge_live(t),
                                    table=self.table[t], block=self.n)
        sent = self.segment_sum(wrap32(
            pc * (flags & FLAG_SEND).sum(dim=1)))
        history = st.history
        if self.classes is None:
            new, received, dup_pc = kernels.faulted_gather_round(
                payload, dup_rows, rec0, self.nbrs, flags, block=self.n)
            sent = sent + dup_pc
        else:
            if dup_rows is not None:
                dup = (flags & kernels.FLAG_DUP) != 0
                sent = sent + self.segment_sum(
                    torch.where(dup, pc[self.src], 0).sum(dim=1))
            kernels.fold_freeze(history[t % self.ring], payload, active,
                                self.n)
            inbox = None
            for v, cls in self.classes.items():
                slot = send_slot(t, v, self.ring)
                if slot is None:
                    continue
                term = kernels.gather_or(history[slot], self.nbrs,
                                         self._live_del_at(t - (v - 1))
                                         & cls)
                inbox = term if inbox is None else inbox | term
            if inbox is None:
                inbox = torch.zeros_like(rec0)
            new = inbox.masked_fill(~up[:, None], 0) & ~rec0
            received = rec0 | new
        kernels.fold_freeze(st.received, received, active, self.n,
                            st.frontier, new)
        msgs = wrap32(st.msgs + sent)
        return BatchState(
            received=st.received, frontier=st.frontier,
            msgs=torch.where(active, msgs, st.msgs), history=history), up

    def tel_row(self, t: int, fr0_pc, st: BatchState, up: torch.Tensor,
                mask) -> torch.Tensor:
        """(S, 5) int64: round ``t``'s telemetry rows (the sequential
        :meth:`BroadcastSim._tel_series`), 0 where ``mask`` is False."""
        live, fr, new, known, ms = mask
        zero = torch.zeros(self.s_count, dtype=torch.int64,
                           device=self.device)
        cols = (self.segment_sum(up) if live else zero,
                fr0_pc if fr else zero,
                self.popcounts(st.frontier) if new else zero,
                self.popcounts(st.received) if known else zero,
                st.msgs if ms else zero)
        return torch.stack(cols, dim=1) & MASK32


def _batch_converged(fb: FoldedBatch, st: BatchState, target: torch.Tensor,
                     member: torch.Tensor) -> torch.Tensor:
    """(S,) bool: each scenario's member rows (``member`` (S N, 1)) hold
    its target (``target`` (S N, W), the scenario's target on each row)."""
    ok = (st.received == target) | ~member
    return ok.view(fb.s_count, -1).all(dim=1)
