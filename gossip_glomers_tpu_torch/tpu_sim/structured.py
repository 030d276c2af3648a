"""Structured-topology neighbor exchange on words-major (W, N) bitsets.

The port of gossip_glomers_tpu/tpu_sim/structured.py's single-device
exchanges and sync diffs for every named topology:

- **k-ary tree**: node i's parent is (i-1)//k — a repeat by k — and node
  p's children are kp+1..kp+k — a pad, a (W, N/k, k) view and an OR over
  the last axis;
- **grid**: ±cols and ±1 shifts with zero fill, the ±1 pair masked by
  column so rows do not wrap;
- **line**: ±1 shifts; **ring** and **circulant**: ±stride rotations.

The functions below are the plain PyTorch versions, shaped as the
reference shapes them (``torch.roll``, ``torch.cat``, column masks).
:func:`make_exchange` hands the simulator exchange objects that run the
hand-written kernels of :mod:`.kernels` on a CUDA device: the tree's own
kernels, and for the other four the shift kernels driven by a direction
table (:func:`shift_dirs`).  :func:`make_sync_diff` hands the
server-ledger's per-edge diff closure.

Maelstrom's faults on this path: every structured delivery is an OR of
per-direction terms with a host-known sender map (the direction-row
contracts of :func:`fault_dir_senders` and :func:`nemesis_dir_pairs`), so
a partition window or a crash window is a host-precomputed (D, N) mask
and the loss and dup coins are elementwise hashes over (D, N) id rows.
:func:`make_faulted` bundles a partition schedule's masks with the masked
exchange and sync-diff closures, :func:`make_nemesis` a whole
:class:`.faults.NemesisSpec` (crash/restart, loss, dup, composed with
partition windows).  Their closures take the round's liveness as packed
rows (:func:`.kernels.pack_bits`, (D, ceil(N/32)) int32) and run the
masked kernels (:func:`.kernels.tree_masked_exchange`,
:func:`.kernels.shift_masked_exchange`) through the exchange objects'
``masked`` calls.  Single device only: the reference's halo closures
(``sharded_*``) are None here (ROADMAP.md Queue A item 10).

The reference has two lowerings of ``tree_from_kids`` (a lane-roll fold
for mid W and a reshape fold otherwise), pinned bit-identical; the port
keeps the reshape fold only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import faults, kernels
from ..parallel.topology import grid_cols
from .engine import resolve_device
from .kernels import MASK32, MASK_LEFT, MASK_RIGHT, WRAP, ShiftDirs


def _zeros(payload: torch.Tensor, n: int) -> torch.Tensor:
    return payload.new_zeros(payload.shape[0], n)


def tree_from_parent(payload: torch.Tensor,
                     branching: int = 4) -> torch.Tensor:
    """inbox[:, i] = payload[:, (i-1)//k] for i >= 1 (zeros at the
    root) — the parent->child half of :func:`tree_exchange`."""
    w, n = payload.shape
    k = branching
    n_parents = (n - 1 + k - 1) // k
    fp = payload[:, :n_parents].repeat_interleave(k, dim=1)[:, :n - 1]
    return torch.cat([_zeros(payload, 1), fp], dim=1)


def tree_from_kids(payload: torch.Tensor,
                   branching: int = 4) -> torch.Tensor:
    """inbox[:, p] = OR payload[:, kp+1 .. kp+k] — the child->parent
    half of :func:`tree_exchange` (zeros for p >= n_parents; the last
    parent may have fewer than k children)."""
    w, n = payload.shape
    k = branching
    n_parents = (n - 1 + k - 1) // k
    m = n_parents * k
    kids = torch.cat([payload[:, 1:], _zeros(payload, m - (n - 1))], dim=1)
    fk = functools.reduce(torch.bitwise_or,
                          kids.view(w, n_parents, k).unbind(dim=2))
    return torch.cat([fk, _zeros(payload, n - n_parents)], dim=1)


def tree_exchange(payload: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """inbox for the k-ary tree of parallel/topology.py::tree — i's
    neighbors are parent (i-1)//k and children ki+1..ki+k."""
    if payload.shape[1] == 1:
        return torch.zeros_like(payload)
    return (tree_from_parent(payload, branching)
            | tree_from_kids(payload, branching))


def grid_terms(pu: torch.Tensor, pd: torch.Tensor, pl: torch.Tensor,
               pr: torch.Tensor, cols: int) -> torch.Tensor:
    """Grid delivery from per-direction source payloads: up/down are
    ±cols shifts, left/right ±1 shifts with the ragged-row wrap masks."""
    w, n = pu.shape
    c = min(cols, n)
    up = torch.cat([pu[:, c:], _zeros(pu, c)], dim=1)
    down = torch.cat([_zeros(pd, c), pd[:, :n - c]], dim=1)
    left = torch.cat([pl[:, 1:], _zeros(pl, 1)], dim=1)
    right = torch.cat([_zeros(pr, 1), pr[:, :-1]], dim=1)
    # column masks kill the row wrap-around of the left/right shifts
    col_idx = torch.arange(n, device=pu.device) % cols
    left = torch.where((col_idx < cols - 1)[None, :], left, 0)
    right = torch.where((col_idx > 0)[None, :], right, 0)
    return up | down | left | right


def grid_exchange(payload: torch.Tensor, cols: int) -> torch.Tensor:
    """inbox for the 2D grid of parallel/topology.py::grid — width
    ``cols``, neighbors up/down/left/right, last row possibly ragged."""
    return grid_terms(payload, payload, payload, payload, cols)


def line_terms(pf: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Line delivery from per-direction source payloads."""
    fwd = torch.cat([pf[:, 1:], _zeros(pf, 1)], dim=1)
    bwd = torch.cat([_zeros(pb, 1), pb[:, :-1]], dim=1)
    return fwd | bwd


def ring_exchange(payload: torch.Tensor) -> torch.Tensor:
    """inbox for parallel/topology.py::ring (n >= 3)."""
    return torch.roll(payload, 1, dims=1) | torch.roll(payload, -1, dims=1)


def circulant_exchange(payload: torch.Tensor,
                       strides: list[int]) -> torch.Tensor:
    """inbox for parallel/topology.py::circulant — the epidemic expander
    as pure rotations: one ±roll pair per stride."""
    out = None
    for s in strides:
        term = torch.roll(payload, s, dims=1) | torch.roll(payload, -s,
                                                           dims=1)
        out = term if out is None else out | term
    return out if out is not None else torch.zeros_like(payload)


def line_exchange(payload: torch.Tensor) -> torch.Tensor:
    """inbox for parallel/topology.py::line."""
    return line_terms(payload, payload)


def _dir_diff(term: torch.Tensor, recv: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """() int64 holding a uint32 — both directed diffs of each edge,
    computed at the receiving end: ``term`` holds the neighbor's
    received set (or zeros where the neighbor does not exist — those
    columns MUST be masked off, or the reverse diff would count the whole
    local set)."""
    per = (kernels.col_popcount(term & ~recv)
           + kernels.col_popcount(recv & ~term))
    if mask is not None:
        per = torch.where(mask, per, 0)
    return per.sum(dtype=torch.int64) & MASK32


def _zero_diff(recv: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=recv.device)


def tree_sync_diff(recv: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """() int64 holding a uint32 — the anti-entropy pairwise diff volume
    over every tree edge (parent, child)."""
    w, n = recv.shape
    k = branching
    if n == 1:
        return _zero_diff(recv)
    n_parents = (n - 1 + k - 1) // k
    parent = recv[:, :n_parents].repeat_interleave(k, dim=1)[:, :n - 1]
    return _dir_diff(parent, recv[:, 1:])


def grid_sync_diff(recv: torch.Tensor, cols: int) -> torch.Tensor:
    w, n = recv.shape
    c = min(cols, n)
    # vertical edges i <-> i+cols (i + cols < n)
    vert = (_dir_diff(recv[:, c:], recv[:, :n - c]) if n > c
            else _zero_diff(recv))
    # horizontal edges i <-> i+1 within a row
    mask = (torch.arange(n - 1, device=recv.device) % cols) < cols - 1
    horiz = _dir_diff(recv[:, 1:], recv[:, :-1], mask)
    return (vert + horiz) & MASK32


def circulant_sync_diff(recv: torch.Tensor,
                        strides: list[int]) -> torch.Tensor:
    out = _zero_diff(recv)
    for s in strides:
        out = out + _dir_diff(torch.roll(recv, s, dims=1), recv)
    return out & MASK32


def line_sync_diff(recv: torch.Tensor) -> torch.Tensor:
    return _dir_diff(recv[:, 1:], recv[:, :-1])


def make_sync_diff(topology: str, n: int, **kw):
    """Single-device per-edge sync-diff closure ``diff(recv) -> () int64``
    holding a uint32, or None for unstructured topologies."""
    if topology == "tree":
        k = kw.get("branching", 4)
        return lambda r: tree_sync_diff(r, k)
    if topology == "grid":
        cols = kw.get("cols") or grid_cols(n)
        return lambda r: grid_sync_diff(r, cols)
    if topology == "ring":
        return lambda r: circulant_sync_diff(r, [1])
    if topology == "circulant":
        strides = list(kw["strides"])
        return lambda r: circulant_sync_diff(r, strides)
    if topology == "line":
        return line_sync_diff
    return None


def shift_dirs(topology: str, n: int, **kw) -> ShiftDirs:
    """The shift kernels' direction table of a grid, ring, line or
    circulant on ``n`` nodes — the same deliveries as
    :func:`grid_exchange`, :func:`ring_exchange`, :func:`line_exchange`
    and :func:`circulant_exchange`.  ``torch.roll(p, s)`` delivers
    ``p[(i - s) mod n]`` to node i, so a +s roll is offset ``-s mod n``."""
    if topology == "grid":
        cols = kw.get("cols") or grid_cols(n)
        c = min(cols, n)
        return ShiftDirs(offs=(c, -c, 1, -1),
                         flags=(0, 0, MASK_LEFT, MASK_RIGHT), cols=cols)
    if topology == "line":
        return ShiftDirs(offs=(1, -1), flags=(0, 0))
    if topology in ("ring", "circulant"):
        strides = [1] if topology == "ring" else list(kw["strides"])
        offs = tuple(o for s in strides for o in ((-s) % n, s % n))
        return ShiftDirs(offs=offs, flags=(WRAP,) * len(offs))
    raise ValueError(f"{topology!r} is not a shift topology")


@dataclass(frozen=True)
class TreeExchange:
    """The simulator's tree exchange: ``exchange(payload) -> inbox`` and
    the fused pure-flood round, both through :mod:`.kernels` (kernels on
    a CUDA device, plain versions on the CPU)."""

    branching: int = 4

    def __call__(self, payload: torch.Tensor) -> torch.Tensor:
        return kernels.tree_exchange(payload, self.branching)

    def flood_round(self, received: torch.Tensor, frontier: torch.Tensor,
                    frontier_next: torch.Tensor) -> torch.Tensor:
        return kernels.tree_flood_round(received, frontier, frontier_next,
                                        self.branching)

    def masked(self, payload: torch.Tensor, live_parent: torch.Tensor,
               live_kids: torch.Tensor) -> torch.Tensor:
        """The exchange under per-edge liveness: packed rows gating the
        from-parent term at receivers and each child's payload before
        the fold (:func:`.kernels.tree_masked_exchange`)."""
        return kernels.tree_masked_exchange(payload, live_parent, live_kids,
                                            self.branching)


@dataclass(frozen=True)
class ShiftExchange:
    """The simulator's grid / ring / line / circulant exchange: the shift
    kernels over one direction table (:func:`shift_dirs`)."""

    dirs: ShiftDirs

    def __call__(self, payload: torch.Tensor) -> torch.Tensor:
        return kernels.shift_exchange(payload, self.dirs)

    def flood_round(self, received: torch.Tensor, frontier: torch.Tensor,
                    frontier_next: torch.Tensor) -> torch.Tensor:
        return kernels.shift_flood_round(received, frontier, frontier_next,
                                         self.dirs)

    def masked(self, payload: torch.Tensor,
               live: torch.Tensor) -> torch.Tensor:
        """The exchange with direction d's term gated by packed row d of
        ``live`` (:func:`.kernels.shift_masked_exchange`)."""
        return kernels.shift_masked_exchange(payload, live, self.dirs)


def make_exchange(topology: str, n: int, **kw):
    """Exchange object for a named topology, or None if the topology has
    no structured form (the caller then takes the adjacency gather)."""
    if topology == "tree":
        return TreeExchange(kw.get("branching", 4))
    if topology in ("grid", "ring", "line", "circulant"):
        return ShiftExchange(shift_dirs(topology, n, **kw))
    return None


# -- faults on the structured path --------------------------------------
#
# Direction-row contract (fault_dir_senders, the masked exchanges and
# the masked sync diffs):
# - tree(k):   row 0 = parent edge at CHILD positions (masks both the
#              from-parent delivery and the pre-fold kids payload: one
#              symmetric edge, one mask); rows 1..k = child slot j at
#              PARENT positions (degree accounting only).
# - grid:      up (i<-i+cols), down (i<-i-cols), left (i<-i+1, row-
#              local), right (i<-i-1, row-local): shift_dirs' order.
# - ring:      +1, -1.   line: fwd (i<-i+1), bwd (i<-i-1).
# - circulant: +s0, -s0, +s1, -s1, ... per stride (the senders i - s,
#              i + s): shift_dirs' order.
#
# live.sum(0)[i] is node i's live undirected degree: each symmetric edge
# has one receiver-side entry at each endpoint.


def fault_dir_senders(topology: str, n: int, **kw) -> np.ndarray | None:
    """(D, N) int64: the sender of each direction row at each receiver
    position, -1 where the edge does not exist (the contract above).
    None for unstructured topologies."""
    idx = np.arange(n, dtype=np.int64)
    if topology == "tree":
        k = kw.get("branching", 4)
        rows = [np.where(idx >= 1, (idx - 1) // k, -1)]
        for j in range(k):
            child = k * idx + 1 + j
            rows.append(np.where(child < n, child, -1))
        return np.stack(rows)
    if topology == "grid":
        cols = kw.get("cols") or grid_cols(n)
        col = idx % cols
        up = np.where(idx + cols < n, idx + cols, -1)
        down = np.where(idx - cols >= 0, idx - cols, -1)
        left = np.where((col < cols - 1) & (idx + 1 < n), idx + 1, -1)
        right = np.where(col > 0, idx - 1, -1)
        return np.stack([up, down, left, right])
    if topology in ("ring", "circulant"):
        strides = [1] if topology == "ring" else list(kw["strides"])
        rows = []
        for s in strides:
            rows.append((idx - s) % n)
            rows.append((idx + s) % n)
        return np.stack(rows)
    if topology == "line":
        fwd = np.where(idx + 1 < n, idx + 1, -1)
        bwd = np.where(idx - 1 >= 0, idx - 1, -1)
        return np.stack([fwd, bwd])
    return None


def fault_masks(topology: str, n: int, groups: np.ndarray,
                **kw) -> tuple[np.ndarray, np.ndarray] | None:
    """Host masks of a partition schedule: ``(exists (D, N) bool, same
    (P, D, N) bool)``, ``groups`` the schedule's (P, N) group ids
    (:class:`.broadcast.Partitions`).  None for unstructured
    topologies."""
    snd = fault_dir_senders(topology, n, **kw)
    if snd is None:
        return None
    exists = snd >= 0
    g = np.asarray(groups)
    sender_groups = g[:, np.clip(snd, 0, n - 1)]      # (P, D, N)
    same = g[:, None, :] == sender_groups
    return exists, same


def _mask_cols(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Zero the columns of (W, N) ``x`` where (N,) bool ``m`` is False."""
    return torch.where(m[None, :], x, 0)


def tree_masked_terms(payload: torch.Tensor, m_parent: torch.Tensor,
                      m_kids: torch.Tensor,
                      branching: int = 4) -> torch.Tensor:
    """The tree inbox with the from-parent term masked at receivers by
    ``m_parent`` and the payload masked at child positions by ``m_kids``
    before the k:1 fold ((N,) bool each)."""
    if payload.shape[1] == 1:
        return torch.zeros_like(payload)
    return (_mask_cols(tree_from_parent(payload, branching), m_parent)
            | tree_from_kids(_mask_cols(payload, m_kids), branching))


def tree_masked_exchange(payload: torch.Tensor, live: torch.Tensor,
                         branching: int = 4) -> torch.Tensor:
    """:func:`tree_exchange` under per-edge liveness ((D, N) bool rows):
    live[0] masks the parent edge at child positions, applied to the
    from-parent delivery AND to the child payload before the fold."""
    return tree_masked_terms(payload, live[0], live[0], branching)


def _shift(p: torch.Tensor, off: int) -> torch.Tensor:
    """out[:, i] = p[:, i + off], zero outside [0, n)."""
    return kernels._shifted(p, off, False)


def grid_masked_exchange(payload: torch.Tensor, live: torch.Tensor,
                         cols: int) -> torch.Tensor:
    """:func:`grid_exchange` under per-edge liveness (the row-wrap column
    masks are folded into the exists rows)."""
    c = min(cols, payload.shape[1])
    return (_mask_cols(_shift(payload, c), live[0])
            | _mask_cols(_shift(payload, -c), live[1])
            | _mask_cols(_shift(payload, 1), live[2])
            | _mask_cols(_shift(payload, -1), live[3]))


def circulant_masked_exchange(payload: torch.Tensor, live: torch.Tensor,
                              strides: list[int]) -> torch.Tensor:
    out = torch.zeros_like(payload)
    for i, s in enumerate(strides):
        out |= (_mask_cols(torch.roll(payload, s, dims=1), live[2 * i])
                | _mask_cols(torch.roll(payload, -s, dims=1),
                             live[2 * i + 1]))
    return out


def line_masked_exchange(payload: torch.Tensor,
                         live: torch.Tensor) -> torch.Tensor:
    return (_mask_cols(_shift(payload, 1), live[0])
            | _mask_cols(_shift(payload, -1), live[1]))


def tree_masked_sync_diff(recv: torch.Tensor, live: torch.Tensor,
                          branching: int = 4) -> torch.Tensor:
    """() int64 holding a uint32: :func:`tree_sync_diff` over the parent
    edges live at their child (row 0)."""
    w, n = recv.shape
    k = branching
    if n == 1:
        return _zero_diff(recv)
    n_parents = (n - 1 + k - 1) // k
    parent = recv[:, :n_parents].repeat_interleave(k, dim=1)[:, :n - 1]
    return _dir_diff(parent, recv[:, 1:], live[0][1:])


def grid_masked_sync_diff(recv: torch.Tensor, live: torch.Tensor,
                          cols: int) -> torch.Tensor:
    c = min(cols, recv.shape[1])
    return (_dir_diff(_shift(recv, c), recv, live[0])
            + _dir_diff(_shift(recv, 1), recv, live[2])) & MASK32


def circulant_masked_sync_diff(recv: torch.Tensor, live: torch.Tensor,
                               strides: list[int]) -> torch.Tensor:
    out = _zero_diff(recv)
    for i, s in enumerate(strides):
        out = out + _dir_diff(torch.roll(recv, s, dims=1), recv, live[2 * i])
    return out & MASK32


def line_masked_sync_diff(recv: torch.Tensor,
                          live: torch.Tensor) -> torch.Tensor:
    return _dir_diff(_shift(recv, 1), recv, live[0])


def _unported_shards(n_shards: int | None) -> None:
    if n_shards is not None:
        raise NotImplementedError(
            "the halo (n_shards) closures of the structured fault bundles "
            "are not ported to PyTorch yet (ROADMAP.md Queue A item 10)")


def _masked_diffs(topology: str, n: int, **kw):
    """The masked per-edge sync-diff closure ``df(recv, live)`` over
    packed (D, ceil(N/32)) rows of the degree contract, shared by
    :func:`make_faulted` and :func:`make_nemesis`; None for unstructured
    topologies."""
    if topology == "tree":
        k = kw.get("branching", 4)
        diff = functools.partial(tree_masked_sync_diff, branching=k)
    elif topology == "grid":
        diff = functools.partial(grid_masked_sync_diff,
                                 cols=kw.get("cols") or grid_cols(n))
    elif topology in ("ring", "circulant"):
        strides = [1] if topology == "ring" else list(kw["strides"])
        diff = functools.partial(circulant_masked_sync_diff,
                                 strides=strides)
    elif topology == "line":
        diff = line_masked_sync_diff
    else:
        return None
    return lambda r, lv: diff(r, kernels.unpack_bits(lv, n))


@dataclass(frozen=True)
class StructuredFaults:
    """What a words-major BroadcastSim needs to run a partition schedule
    gather-free (built by :func:`make_faulted`):

    - ``exists`` (D, N) bool: static edge existence per direction row;
    - ``same`` (P, D, N) bool: per window and direction, receiver and
      sender in one group;
    - ``exchange(payload, live)`` / ``sync_diff(recv, live)``: the masked
      closures, ``live`` the round's (D, ceil(N/32)) packed rows;
    - ``sharded_exchange`` / ``sharded_sync_diff``: None (item 10)."""

    exists: np.ndarray
    same: np.ndarray
    exchange: Callable
    sync_diff: Callable
    sharded_exchange: Callable | None = None
    sharded_sync_diff: Callable | None = None


def make_faulted(topology: str, n: int, groups: np.ndarray,
                 n_shards: int | None = None,
                 **kw) -> StructuredFaults | None:
    """The :class:`StructuredFaults` bundle of a topology under a
    partition schedule (``groups``: its (P, N) group ids).  The exchange
    runs the masked kernels: the tree's with row 0 as both of its rows,
    the shift topologies' with every row.  None for unstructured
    topologies."""
    _unported_shards(n_shards)
    masks = fault_masks(topology, n, groups, **kw)
    if masks is None:
        return None
    exists, same = masks
    ex = make_exchange(topology, n, **kw)
    if topology == "tree":
        def exchange(p, lv):
            return ex.masked(p, lv[0], lv[0])
    else:
        exchange = ex.masked
    return StructuredFaults(exists, same, exchange,
                            _masked_diffs(topology, n, **kw))


# -- the structured nemesis ---------------------------------------------
#
# Delivery direction-row contract (nemesis_dir_pairs):
# - tree(k): TWO rows, both at CHILD positions: row 0 = the parent->child
#   edge (src = parent(i), dst = i), masking the from-parent delivery;
#   row 1 = the child->parent edge (src = i, dst = parent(i)), masking
#   the kids payload before the fold.
# - grid / ring / line / circulant: the fault_dir_senders rows
#   (receiver-side, dst = i).
#
# The ledgers need the per-node live undirected degree, which the tree's
# 2-row contract cannot give per node: the DEGREE contract
# (fault_dir_senders, 1 + k rows for the tree) rides along from its own
# host masks (WMNemesisArrays.deg_*).


def nemesis_dir_pairs(topology: str, n: int, **kw):
    """(src, dst, exists), each (D, N): the delivery contract above, node
    ids with -1 at pad positions; None for unstructured topologies."""
    idx = np.arange(n, dtype=np.int64)
    if topology == "tree":
        k = kw.get("branching", 4)
        parent = np.where(idx >= 1, (idx - 1) // k, -1)
        child = np.where(idx >= 1, idx, -1)
        src = np.stack([parent, child])
        dst = np.stack([child, parent])
        return src, dst, src >= 0
    snd = fault_dir_senders(topology, n, **kw)
    if snd is None:
        return None
    dst = np.where(snd >= 0, idx[None, :], -1)
    return snd, dst, snd >= 0


def coin_dirs(topology: str, n: int, *, degree: bool = False,
              **kw) -> np.ndarray | None:
    """(D, 4) int64: the closed forms of each direction row's sender and
    receiver ids (:func:`.kernels.coin_id`), equal to
    :func:`nemesis_dir_pairs`' ids (``degree``: :func:`fault_dir_senders`'
    senders and the receiver i) at every position where the edge exists.
    ``wm_fault_coins`` computes its ids from them.  None for unstructured
    topologies."""
    ident = kernels.coin_id(kernels.COIN_IDENT)

    def shift(off: int) -> tuple[int, int]:
        return kernels.coin_id(kernels.COIN_SHIFT, off % n)

    if topology == "tree":
        k = kw.get("branching", 4)
        parent = kernels.coin_id(kernels.COIN_PARENT, k)
        if degree:
            rows = [parent + ident] + [
                kernels.coin_id(kernels.COIN_CHILD, k, j) + ident
                for j in range(k)]
        else:
            rows = [parent + ident, ident + parent]
    elif topology == "grid":
        cols = kw.get("cols") or grid_cols(n)
        rows = [shift(o) + ident for o in (cols, -cols, 1, -1)]
    elif topology in ("ring", "circulant"):
        strides = [1] if topology == "ring" else list(kw["strides"])
        rows = [shift(o) + ident for s in strides for o in (-s, s)]
    elif topology == "line":
        rows = [shift(1) + ident, shift(-1) + ident]
    else:
        return None
    return np.array(rows, dtype=np.int64).reshape(-1, 4)


def _same_groups(groups: np.ndarray, src: np.ndarray, dst: np.ndarray,
                 n: int) -> np.ndarray:
    """(P, D, N) bool: per partition window, the edge's endpoints share a
    group (pad positions read True; exists masks them)."""
    g = np.asarray(groups)
    if g.shape[0] == 0:
        return np.zeros((0,) + src.shape, bool)
    return g[:, np.clip(src, 0, n - 1)] == g[:, np.clip(dst, 0, n - 1)]


def _nem_closures(topology: str, n: int, **kw):
    """The nemesis delivery closures ``(ex, spc)``: ``ex(payload, lv)``
    ORs direction d's structured term of ``payload`` gated by packed row
    d of ``lv`` (the tree's row 1 gates the payload before the fold),
    through the exchange objects' ``masked`` calls; ``spc(d, pc)`` moves
    a (1, N) per-node count vector to direction d's contract positions
    (the dup ledger's popcount at the source: every move is a repeat,
    shift or roll, so counts survive where OR-folds would not).  None for
    unstructured topologies."""
    ex = make_exchange(topology, n, **kw)
    if ex is None:
        return None
    if topology == "tree":
        k = ex.branching

        def exchange(p, lv):
            return ex.masked(p, lv[0], lv[1])

        def spc(d, pc):
            return tree_from_parent(pc, k) if d == 0 else pc

        return exchange, spc
    return ex.masked, lambda d, pc: kernels.shift_term_plain(pc, ex.dirs, d)


@dataclass(frozen=True)
class StructuredNemesis:
    """What a words-major BroadcastSim needs to run a compiled
    :class:`.faults.FaultPlan` (crash/restart amnesia, loss, dup,
    composed with partition windows) gather-free (built by
    :func:`make_nemesis`):

    - ``arrs``: the mask operand (:class:`.faults.WMNemesisArrays`);
    - ``dir_delays`` / ``ring``: None / 1 (per-direction delays are
      ROADMAP.md Queue A item 6.3);
    - ``exchange(payload, lv)`` / ``src_pc(d, pc)``: the delivery and
      count-relocation closures (:func:`_nem_closures`);
    - ``sync_diff(recv, rows)``: the masked per-edge diff over the degree
      contract's packed rows, the loss-only server ledger's sync term;
    - ``sharded_*``: None (item 10)."""

    arrs: "faults.WMNemesisArrays"
    dir_delays: tuple | None
    ring: int
    exchange: Callable
    src_pc: Callable
    sharded_exchange: Callable | None
    sharded_src_pc: Callable | None
    sync_diff: Callable | None
    sharded_sync_diff: Callable | None


def make_nemesis(topology: str, n: int, spec: "faults.NemesisSpec",
                 groups: np.ndarray | None = None, dir_delays=None,
                 n_shards: int | None = None,
                 device: str | torch.device | None = None,
                 **kw) -> StructuredNemesis | None:
    """The :class:`StructuredNemesis` bundle: the words-major mask
    decomposition of ``spec`` (a host NemesisSpec: the crash windows must
    be host data to precompute the per-direction masks), composed with an
    optional partition schedule (``groups``: its (P, N) group ids), its
    tensors on ``device`` (default CUDA, as the port's entry points).
    Pass it to ``BroadcastSim(nemesis=..., fault_plan=spec.compile())``.
    None for unstructured topologies.  ``dir_delays`` and ``n_shards``
    are not ported and raise NotImplementedError."""
    _unported_shards(n_shards)
    if spec.n_nodes != n:
        raise ValueError(f"spec is for {spec.n_nodes} nodes, "
                         f"topology has {n}")
    if spec.has_membership:
        raise ValueError(
            "the words-major structured path does not support "
            "membership events yet: the per-direction mask "
            "decomposition (down_pair/down_cols) has no per-row "
            "join/leave columns, so a membership-bearing plan would "
            "silently mis-simulate — run join/leave campaigns on the "
            "gather path (structured=False)")
    pairs = nemesis_dir_pairs(topology, n, **kw)
    if pairs is None:
        return None
    src, dst, exists = pairs
    if dir_delays is not None:
        dd = tuple(int(x) for x in dir_delays)
        if len(dd) != src.shape[0]:
            raise ValueError(
                f"{topology} takes {src.shape[0]} direction delays, "
                f"got {len(dd)}")
        if any(d < 1 for d in dd):
            raise ValueError("direction delays are rounds >= 1")
        raise NotImplementedError(
            "make_nemesis(dir_delays=...) is not ported to PyTorch yet "
            "(ROADMAP.md Queue A item 6.3)")
    device = resolve_device(device)
    idx = np.arange(n, dtype=np.int64)
    deg_src = fault_dir_senders(topology, n, **kw)
    deg_dst = np.where(deg_src >= 0, idx[None, :], -1)
    g = (np.zeros((0, n), np.int8) if groups is None
         else np.asarray(groups))

    def packed(rows: np.ndarray) -> torch.Tensor:
        return kernels.pack_bits(torch.from_numpy(rows)).to(device)

    def ids(rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.clip(rows, 0, n - 1).astype(np.int32)).to(device)

    def down_pair(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
        return packed(faults.crash_down_rows(spec, a)
                      | faults.crash_down_rows(spec, b))

    arrs = faults.WMNemesisArrays(
        exists=packed(exists), same=packed(_same_groups(g, src, dst, n)),
        down_pair=down_pair(src, dst), src=ids(src), dst=ids(dst),
        coin_dirs=torch.from_numpy(coin_dirs(topology, n, **kw)).to(device),
        deg_exists=packed(deg_src >= 0),
        deg_same=packed(_same_groups(g, deg_src, deg_dst, n)),
        deg_down_pair=down_pair(deg_src, deg_dst), deg_src=ids(deg_src),
        deg_dst=ids(deg_dst),
        deg_coin_dirs=torch.from_numpy(
            coin_dirs(topology, n, degree=True, **kw)).to(device),
        down_cols=torch.from_numpy(faults.crash_down_rows(spec, idx)).to(
            device))
    ex, spc = _nem_closures(topology, n, **kw)
    return StructuredNemesis(arrs, None, 1, ex, spc, None, None,
                             _masked_diffs(topology, n, **kw), None)
