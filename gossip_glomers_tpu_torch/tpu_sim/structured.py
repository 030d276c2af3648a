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

The reference has two lowerings of ``tree_from_kids`` (a lane-roll fold
for mid W and a reshape fold otherwise), pinned bit-identical; the port
keeps the reshape fold only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import kernels
from ..parallel.topology import grid_cols
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


def make_exchange(topology: str, n: int, **kw):
    """Exchange object for a named topology, or None if the topology has
    no structured form (the caller then takes the adjacency gather)."""
    if topology == "tree":
        return TreeExchange(kw.get("branching", 4))
    if topology in ("grid", "ring", "line", "circulant"):
        return ShiftExchange(shift_dirs(topology, n, **kw))
    return None
