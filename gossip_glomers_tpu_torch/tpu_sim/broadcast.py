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

Modes not ported yet raise: meshes (ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import faults, kernels, provenance, telemetry, traffic
from .engine import (active_windows, fori_rounds, resolve_block,
                     resolve_device, scan_blocks, send_slot,
                     stepwise_converge, while_converge, windows_fold)
from .kernels import FLAG_DEL, FLAG_OUT_OK, FLAG_SEND, MASK32

WORD = 32

_UNPORTED = ("mesh", "dcn_mode", "sharded_exchange", "sharded_sync_diff")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               "(ROADMAP.md Queue A item 10)")


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


def _live_del_at(t: int, row_ids: torch.Tensor, nbrs: torch.Tensor,
                 nbr_mask: torch.Tensor, parts: Partitions,
                 plan: faults.FaultPlan | None) -> torch.Tensor:
    """(N, D) bool: the edges that deliver a message sent at round ``t``:
    topology and partition windows, and under a ``plan`` both endpoints
    up and the loss coin kept (:func:`.kernels.fault_coins`' DEL flag;
    ``_live_split``'s ``live_del``)."""
    live = _edge_live(t, row_ids, nbrs, nbr_mask, parts)
    if plan is None:
        return live
    flags = kernels.fault_coins(nbrs, faults.node_up(plan, t, row_ids),
                                live=live, **_coins(plan, t, False, False))
    return (flags & FLAG_DEL) != 0


def _delay_terms(t: int, ring: int, classes: dict[int, torch.Tensor],
                 nbrs: torch.Tensor, nbr_mask: torch.Tensor,
                 parts: Partitions, row_ids: torch.Tensor,
                 plan: faults.FaultPlan | None) -> list:
    """[(ring slot, (N, D) delivering edges)] of round ``t``'s delay
    classes: edge (i, d) of delay v (``classes[v]``, the (N, D) mask
    ``delays == v``) delivers the payload of send round ``t - (v - 1)``
    from its slot, if it was live at that round (:func:`_live_del_at`);
    a class whose send round is below 0 has no term."""
    out = []
    for v, cls in classes.items():
        slot = send_slot(t, v, ring)
        if slot is not None:
            out.append((slot, _live_del_at(t - (v - 1), row_ids, nbrs,
                                           nbr_mask, parts, plan) & cls))
    return out


def _gather_or_delayed(history: torch.Tensor, terms: list,
                       nbrs: torch.Tensor) -> torch.Tensor:
    """The latency ring's delivery (the reference's
    ``_gather_or_delayed``): one :func:`.kernels.gather_or` a delay
    class over its :func:`_delay_terms` edges."""
    out = None
    for slot, live in terms:
        term = _gather_or(history[slot], nbrs, live)
        out = term if out is None else out | term
    return torch.zeros_like(history[0]) if out is None else out


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
    ``_prov_attribute``)."""
    kernels.prov_attribute(new, src, nbrs, prov.arrival, prov.parent,
                           t_next=t + 1, **edges)
    return prov


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
                diff: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The reference-accounted server ledger after round ``t``: floods
    charge `broadcast` to every requesting neighbor (``req_deg``) minus
    the sender (t == 0 rows are client-injected origins) plus one
    `broadcast_ok` per acknowledged delivery (``ack_deg``), at the
    frontier's popcount ``pcf``; sync rounds add read-per-requesting-
    neighbor + read_ok-per-acknowledging-neighbor + the targeted diff
    pushes and their acks (``diff()``, evaluated on sync rounds only)."""
    d2 = req_deg + ack_deg
    coef = d2 if t == 0 else (d2 - 2).clamp(min=0)
    srv = srv_msgs + _dot32(pcf, coef)
    if is_sync:
        srv = srv + wrap32(d2.sum()) + 2 * diff()
    return wrap32(srv)


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
           prov=None):
    """One node-major (adjacency-gather) round — the reference's
    ``_round`` on one device.  ``deg`` is
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
                           classes=classes, prov=prov)
    t = state.t
    is_sync = _is_sync(t, sync_every)
    rec0, fr0 = state.received, state.frontier
    # frontier ⊆ received, so the anti-entropy payload is just `received`
    payload = rec0 if is_sync else fr0
    live = (_edge_live(t, row_ids, nbrs, nbr_mask, parts)
            if parts.active(t) else None)
    deg_topo = nbr_mask.sum(dim=1) if deg is None else deg
    live_deg = deg_topo if live is None else live.sum(dim=1)
    pc = kernels.col_popcount(payload, node_major=True)
    # one value-message per (value, live edge)
    sent = _dot32(pc, live_deg)
    srv = None
    if state.srv_msgs is not None:
        # partitions only: every topology neighbor is asked, every live
        # edge delivers and acknowledges, and diffs flow over live edges
        srv = _srv_ledger(
            state.srv_msgs, t=t, is_sync=is_sync,
            pcf=kernels.col_popcount(fr0, node_major=True) if is_sync
            else pc, req_deg=deg_topo, ack_deg=live_deg,
            diff=lambda: _sync_diff_pc(payload, rec0, nbrs, live))
    history = None
    if classes is None:
        new, received = kernels.gather_flood_round(payload, rec0, nbrs, live)
        if prov is not None:
            prov = _stamp(prov, new, payload, nbrs, t, flags=None
                          if live is None else live.to(torch.uint8)
                          * kernels.FLAG_DEL)
    else:
        history = _ring_push(state.history, payload, t)
        terms = _delay_terms(t, history.shape[0], classes, nbrs, nbr_mask,
                             parts, row_ids, None)
        new = _gather_or_delayed(history, terms, nbrs) & ~rec0
        received = rec0 | new
        if prov is not None:
            prov = _stamp(prov, new, history, nbrs, t, slots=_slot_table(
                terms, nbrs.shape, None, nbrs.device))
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
                classes: dict[int, torch.Tensor] | None = None, prov=None):
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
    down now getting nothing; the round then runs materialized."""
    t = state.t
    wipe = faults.amnesia(plan, t, row_ids)[:, None]
    rec0 = state.received.masked_fill(wipe, 0)
    fr0 = state.frontier.masked_fill(wipe, 0)
    is_sync = _is_sync(t, sync_every)
    # frontier ⊆ received, so the anti-entropy payload is just `received`
    payload = rec0 if is_sync else fr0
    up = faults.node_up(plan, t, row_ids)
    srv_on = state.srv_msgs is not None
    coins = _coins(plan, t, dup_on, out_ok=srv_on)
    dup_rows = rec0 if coins["dup"] else None
    pc = kernels.col_popcount(payload, node_major=True)
    windows = bool(parts.active(t))

    def deliver(lo: int, hi: int):
        """(flags, new, received, sent) of destination rows [lo, hi)."""
        nb = nbrs[lo:hi]
        live = (_edge_live(t, row_ids[lo:hi], nb, nbr_mask[lo:hi], parts)
                if windows else None)
        flags = kernels.fault_coins(nb, up, live=live, row0=lo, **coins)
        new, rec, dup_pc = kernels.faulted_gather_round(
            payload, dup_rows, rec0[lo:hi], nb, flags)
        sent = _dot32(pc[lo:hi], (flags & FLAG_SEND).sum(dim=1)) + dup_pc
        return flags, new, rec, sent

    if union_block is not None and not srv_on and prov is None:
        def slab(carry, lo):
            news, recs, sent = carry
            _, new, rec, s = deliver(lo, lo + union_block)
            return news + [new], recs + [rec], wrap32(sent + s)

        news, recs, sent = scan_blocks(slab, ([], [], 0), nbrs.shape[0],
                                       union_block)
        return BroadcastState(received=torch.cat(recs),
                              frontier=torch.cat(news), t=t + 1,
                              msgs=wrap32(state.msgs + sent), srv_msgs=None)
    history = None
    if classes is None:
        flags, new, received, sent = deliver(0, nbrs.shape[0])
        if prov is not None:
            prov = _stamp(prov, new, payload, nbrs, t, flags=flags,
                          dup=dup_rows)
    else:
        live = _edge_live(t, row_ids, nbrs, nbr_mask, parts) if windows \
            else None
        flags = kernels.fault_coins(nbrs, up, live=live, **coins)
        sent = _dot32(pc, (flags & FLAG_SEND).sum(dim=1))
        if dup_rows is not None:
            src = nbrs.clamp(0, nbrs.shape[0] - 1).to(torch.int64)
            dup = (flags & kernels.FLAG_DUP) != 0
            sent = wrap32(sent + torch.where(dup, pc[src], 0).sum(
                dtype=torch.int64))
        history = _ring_push(state.history, payload, t)
        terms = _delay_terms(t, history.shape[0], classes, nbrs, nbr_mask,
                             parts, row_ids, plan)
        inbox = _gather_or_delayed(history, terms, nbrs)
        new = inbox.masked_fill(~up[:, None], 0) & ~rec0
        received = rec0 | new
        if prov is not None:
            prov = _stamp(prov, new, history, nbrs, t, slots=_slot_table(
                terms, nbrs.shape, up, nbrs.device))
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
            diff=lambda: _sync_diff_pc(payload, rec0, nbrs,
                                       (flags & both) == both))
    out = BroadcastState(received=received, frontier=new, t=t + 1,
                         msgs=wrap32(state.msgs + sent), srv_msgs=srv,
                         history=history)
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
              ) -> BroadcastState:
    """Words-major round (the reference's ``_round_wm``, plain, partition
    and delay modes).  ``deg`` is the per-node topology degree (int64).
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
    if live is None:
        live_deg = deg
        deliver, diff = exchange, sync_diff
    else:
        live_deg = kernels.count_rows(live, deg.shape[0])
        deliver = lambda p: faulted.exchange(p, live)  # noqa: E731
        diff = lambda r: faulted.sync_diff(r, live)  # noqa: E731
    pc = kernels.col_popcount(payload)
    sent = _dot32(pc, live_deg)
    srv = None
    if state.srv_msgs is not None:
        srv = _srv_ledger(
            state.srv_msgs, t=t, is_sync=is_sync,
            pcf=kernels.col_popcount(state.frontier) if is_sync else pc,
            req_deg=deg, ack_deg=live_deg,
            diff=lambda: diff(state.received))
    history = None
    if delayed_exchange is None:
        inbox = deliver(payload)
    else:
        history = _ring_push(state.history, payload, t)
        inbox = delayed_exchange(history, t)
    new = inbox & ~state.received
    return BroadcastState(received=state.received | new, frontier=new,
                          t=t + 1, msgs=wrap32(state.msgs + sent),
                          srv_msgs=srv, history=history)


def _dup_charge(src_pc: Callable, dup: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """() int64 holding a uint32: the popcount at the source of every dup
    edge.  ``counts`` is the (1, N) per-node popcount; ``src_pc`` moves
    it to each direction's contract positions (a repeat, shift or roll:
    no gather), where the packed ``dup`` rows select it."""
    rows = kernels.unpack_bits(dup, counts.shape[1])
    at = torch.cat([src_pc(d, counts) for d in range(rows.shape[0])])
    return wrap32(torch.where(rows, at, 0).sum(dtype=torch.int64))


def _round_wm_nem(state: BroadcastState, *, nem, arrs, plan: faults.FaultPlan,
                  parts: Partitions, sync_every: int, dup_on: bool,
                  deg_topo: torch.Tensor) -> BroadcastState:
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
    nothing new delivered.  The server ledger is off there."""
    t = state.t
    rec0, fr0 = state.received, state.frontier
    wipe = faults.wm_wipe_cols(plan, t, arrs.down_cols)
    if wipe is not None:
        rec0 = rec0.masked_fill(wipe[None, :], 0)
        fr0 = fr0.masked_fill(wipe[None, :], 0)
    is_sync = _is_sync(t, sync_every)
    payload = rec0 if is_sync else fr0
    n = deg_topo.shape[0]
    ps, pe = parts.starts, parts.ends
    deg_live = faults.wm_live_rows(plan, t, arrs, ps, pe, deg=True)
    live_deg = (deg_topo if deg_live is arrs.deg_exists
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
            diff=lambda: nem.sync_diff(rec0, both))
    history = None
    if nem.dir_delays is None:
        live_del, dup = faults.wm_live_del(plan, t, arrs, ps, pe, dup_on)
        inbox = nem.exchange(payload, live_del)
        if dup is not None:
            inbox = inbox | nem.exchange(rec0, dup)
            counts = kernels.col_popcount(rec0)[None, :]
            sent = sent + _dup_charge(nem.src_pc, dup, counts)
    else:
        dd = nem.dir_delays
        history = _ring_push(state.history, payload, t)
        ring = history.shape[0]
        # one liveness and coin evaluation a distinct delay, at its send
        # round, shared by the directions of that delay
        coins = {v: faults.wm_live_del(plan, t - (v - 1), arrs, ps, pe,
                                       False)[0]
                 for v in sorted(set(dd)) if t - (v - 1) >= 0}
        inbox = nem.ring_exchange(history, [
            (d, send_slot(t, v, ring), coins[v][d])
            for d, v in enumerate(dd) if v in coins])
        if active_windows(plan.starts, plan.ends, t):
            # a message in flight to a node that crashed before delivery
            # dies with the process
            up = faults.wm_up_cols(plan, t, arrs.down_cols)
            inbox = inbox.masked_fill(~up[None, :], 0)
        if dup_on:
            _, dup = faults.wm_live_del(plan, t, arrs, ps, pe, True)
            if dup is not None:
                sent = sent + _dup_charge(nem.src_pc, dup, pc[None, :])
    new = inbox & ~rec0
    return BroadcastState(received=rec0 | new, frontier=new, t=t + 1,
                          msgs=wrap32(state.msgs + sent), srv_msgs=srv,
                          history=history)


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
                  fr: torch.Tensor, degs, masks,
                  rounds: int) -> BroadcastState:
    """Recover the value-message ledger of a pure flood in closed form:
    every (node, value) bit in `received` was in the frontier of
    exactly one executed round — flooded to deg neighbors then —
    except the final frontier (arrived last round, never flooded), so
    msgs += sum_i deg_i * (pc_i(received) - pc_i(frontier))."""
    dpc = (kernels.col_popcount(rec)
           - kernels.col_popcount(fr)).to(torch.int64)
    sent = torch.zeros((), dtype=torch.int64, device=rec.device)
    for d, m in zip(degs, masks):
        sent = wrap32(sent + d * wrap32(torch.where(m, dpc, 0).sum()))
    return dataclasses.replace(state, received=rec, frontier=fr,
                               t=state.t + rounds,
                               msgs=wrap32(state.msgs + sent))


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
    """Round-synchronous broadcast simulator on one device (the
    reference's single-device ``BroadcastSim``), under partition
    schedules and fault plans on both layouts.

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
                 **unported) -> None:
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
        state lives (default CUDA; raises if there is none).  Reference
        modes not ported yet (``mesh``, ...) raise when given."""
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value is not None:
                raise _unported(f"BroadcastSim({name}=...)")
        if exchange is not None and not hasattr(exchange, "flood_round"):
            raise TypeError("exchange must come from "
                            "structured.make_exchange")
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
        self.n_nodes = n
        self.n_values = n_values
        self.n_words = num_words(n_values)
        self.sync_every = sync_every
        self.exchange = exchange
        self.words_major = words_major
        self.parts = parts.to(self.device)
        self._host_deg = (nbrs >= 0).sum(axis=1).astype(np.int64)
        self.deg = torch.as_tensor(self._host_deg, device=self.device)
        if self.words_major:
            f = self._faulted
            if f is not None:
                self._fx_exists = kernels.pack_bits(
                    torch.from_numpy(f.exists)).to(self.device)
                self._fx_same = kernels.pack_bits(
                    torch.from_numpy(f.same)).to(self.device)
            bundle = nemesis if nemesis is not None else f
            if bundle is not None:
                self._srv_on = srv_ledger and bundle.sync_diff is not None
            else:
                self._srv_on = srv_ledger and sync_diff is not None
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
            self.nbrs = torch.as_tensor(np.asarray(nbrs, np.int32),
                                        device=self.device)
            self.nbr_mask = self.nbrs >= 0
            self.row_ids = torch.arange(n, device=self.device)
        if nemesis is not None:
            self._nem_arrs = nemesis.arrs.to(self.device)
            self._nem_deg = kernels.count_rows(self._nem_arrs.deg_exists, n)
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
                # coins + gather temps), about 16 bytes per edge slot
                self._ub = resolve_block(n, union_block,
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

    def _setup_delays(self, delays, delayed, edge_delayed, nemesis) -> None:
        """The delay mode's ring length, its device operands and its
        delivery closure ``self._delayed_ex(history, t)`` (None for the
        gather path's delays and the nemesis, which their rounds take)."""
        self._classes = None
        self._delayed_ex = None
        self.ring = 1
        if delays is not None:
            self._classes = delay_classes(torch.as_tensor(
                np.asarray(delays, np.int32), device=self.device))
            self.ring = max(self._classes)
        elif delayed is not None:
            self.ring = delayed.ring
            if hasattr(delayed, "same"):
                self._delayed_ex = lambda h, t: delayed.exchange(
                    h, t, self._live_at)
            else:
                self._delayed_ex = delayed.exchange
        elif edge_delayed is not None:
            ed = edge_delayed
            self.ring = ed.ring
            rows = ed.class_rows(self.device)
            if hasattr(ed, "del_same"):
                dsame = kernels.pack_bits(torch.from_numpy(ed.del_same)).to(
                    self.device)
                ps, pe = self.parts.starts, self.parts.ends
                self._delayed_ex = lambda h, t: ed.exchange(
                    h, t, rows, ed.live_by_delay(dsame, ps, pe, t))
            else:
                self._delayed_ex = lambda h, t: ed.exchange(h, t, rows)
        elif nemesis is not None and nemesis.dir_delays is not None:
            self.ring = nemesis.ring
        self._delay_mode = (delays is not None or delayed is not None
                            or edge_delayed is not None
                            or (nemesis is not None
                                and nemesis.dir_delays is not None))

    # -- construction ----------------------------------------------------

    def init_state(self, inject: np.ndarray) -> BroadcastState:
        received = _bits_from_numpy(inject, self.words_major).to(
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
        target every node must reach."""
        union = np.bitwise_or.reduce(np.asarray(inject, np.uint32), axis=0)
        return torch.from_numpy(union.view(np.int32)).to(self.device)

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
                                 dup_on=self._fp_dup, deg_topo=self._nem_deg)
        if self.words_major:
            return _round_wm(state, deg=self.deg,
                             sync_every=self.sync_every,
                             exchange=self.exchange,
                             sync_diff=self.sync_diff if self._srv_on
                             else None,
                             live=self._live_rows(state.t),
                             faulted=self._faulted,
                             delayed_exchange=self._delayed_ex)
        return _round(state, row_ids=self.row_ids, nbrs=self.nbrs,
                      nbr_mask=self.nbr_mask, parts=self.parts,
                      sync_every=self.sync_every, deg=self.deg,
                      plan=self.fault_plan, dup_on=self._fp_dup,
                      union_block=self._ub, classes=self._classes)

    def converged(self, state: BroadcastState,
                  target: torch.Tensor) -> bool:
        t = target[:, None] if self.words_major else target[None, :]
        return bool((state.received == t).all())

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
                    and 0 < rounds <= self.sync_every)
        if not flood_ok:
            def run(state: BroadcastState) -> BroadcastState:
                return fori_rounds(self.step, state, rounds)
            return run, None

        degs, masks = _degree_masks(self._host_deg, self.device)
        flood = _flood_loop(self.exchange, rounds)

        def loop_fn(rec: torch.Tensor, fr: torch.Tensor):
            if not donate:
                rec, fr = rec.clone(), fr.clone()
            return flood(rec, fr)

        def finish(state0: BroadcastState, loop_out) -> BroadcastState:
            return _flood_ledger(state0, *loop_out, degs, masks, rounds)

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
            ix = traffic.client_index(tspec, self.n_nodes, self.device)
            self._traffic_validate(tspec)
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
        accept = (faults.node_up(plan, t, node) if plan is not None
                  else torch.ones_like(arr))
        if tspec.intake is not None:
            accept = accept & (
                traffic.intake_rank(arr, tspec.clients_per_node)
                < tspec.intake)
        ts, ok, kslot = traffic.issue(ts, arr, accept, t)
        v = ix["ids"] * tspec.ops_per_client + kslot
        w = torch.where(ok, v // WORD, 0)
        bit = kernels._wrap_i32(torch.where(ok, 1 << (v % WORD), 0))
        at = (w * self.n_nodes + node if self.words_major
              else node * self.n_words + w)
        state.received.view(-1).index_add_(0, at, bit)
        state.frontier.view(-1).index_add_(0, at, bit)
        return state, ts

    def _traffic_done(self, s2: BroadcastState, ts, tspec, ix: dict):
        """Per-op visibility: the op's value bit at every node, read from
        the all-nodes words (:func:`.kernels.and_fold`)."""
        all_words = kernels.and_fold(s2.received,
                                     node_major=not self.words_major)

        def bit_fn(lo, block):
            sl = slice(lo, lo + block)
            return ((all_words[ix["v_word"][sl]] >> ix["v_shift"][sl])
                    & 1) > 0

        return traffic.done_scan(ts, bit_fn, s2.t, ix["block"])

    def _popcount(self, x: torch.Tensor) -> torch.Tensor:
        """() int64: the set bits of a bitset in the sim's layout
        (:func:`.kernels.col_popcount`)."""
        return kernels.col_popcount(
            x, node_major=not self.words_major).sum(dtype=torch.int64)

    def _tel_series(self, t: int, fr0_pc, s1: BroadcastState,
                    mask) -> tuple:
        """Round ``t``'s telemetry row (``telemetry.SIM_SERIES
        ['broadcast']``): liveness, the popcount of the frontier that
        went out (``fr0_pc``, taken before the round), of the new
        frontier and of ``received``, the value-message total; only the
        columns ``mask`` keeps."""
        live, _fr0, new, known, _msgs = mask
        return (telemetry.live_count(self.fault_plan, t, self.n_nodes)
                if live else None, fr0_pc,
                self._popcount(s1.frontier) if new else None,
                self._popcount(s1.received) if known else None, s1.msgs)

    def traffic_state(self, tspec) -> "traffic.TrafficState":
        return traffic.init_state(tspec, device=self.device)

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
            fr0_pc = (self._popcount(state.frontier)
                      if tel is not None and mask[1] else None)
            state = self.step(state)
            ts = self._traffic_done(state, ts, tspec, ix)
            if tel is not None:
                vals = (self._tel_series(t, fr0_pc, state, mask[:5])
                        + traffic.tel_series(ts))
                tel = telemetry.record(tel, t, vals, mask)
        return (state, ts) if tel is None else (state, ts, tel)

    # -- observed runs: the telemetry ring and the provenance record -------

    def telemetry_state(self, tspec) -> "telemetry.TelemetryState":
        return telemetry.init_state(tspec, device=self.device)

    def provenance_state(self, pspec, inject) -> "provenance.BroadcastProv":
        """A fresh (N, V) provenance record on the sim's device, the origin
        cells stamped from the round-0 ``inject`` bitset."""
        return provenance.init_broadcast(
            self.n_nodes, self.n_values, np.asarray(inject, np.uint32),
            device=self.device)

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
        leaves that were passed, in order."""
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
            fr0_pc = (self._popcount(state.frontier)
                      if tel is not None and mask[1] else None)
            if prov is None:
                state = self.step(state)
            else:
                state, prov = _round(
                    state, row_ids=self.row_ids, nbrs=self.nbrs,
                    nbr_mask=self.nbr_mask, parts=self.parts,
                    sync_every=self.sync_every, deg=self.deg,
                    plan=self.fault_plan, dup_on=self._fp_dup,
                    union_block=None, classes=self._classes, prov=prov)
            if tel is not None:
                tel = telemetry.record(
                    tel, t, self._tel_series(t, fr0_pc, state, mask), mask)
        return ((state,) + (() if tel is None else (tel,))
                + (() if prov is None else (prov,)))

    # -- readout ---------------------------------------------------------

    def received_node_major(self, state: BroadcastState) -> np.ndarray:
        """(N, W) uint32 received bitset."""
        return _bits_to_numpy(state.received, self.words_major)

    def inject_mid(self, state: BroadcastState, node: int,
                   value: int) -> BroadcastState:
        """A client broadcast mid-run: ``value`` set at ``node`` (received
        and frontier), so the next round floods it, out of place.  The
        server ledger, where it is on, takes the origin's correction: one
        send and one ack more than the learner the next round charges it
        as.  The gather path only, as in the reference."""
        if self.words_major:
            raise ValueError("inject_mid targets the gather path")
        w, b = value // WORD, 1 << (value % WORD)
        bit = b - (1 << 32) if b >= 1 << 31 else b
        received, frontier = state.received.clone(), state.frontier.clone()
        received[node, w] |= bit
        frontier[node, w] |= bit
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
