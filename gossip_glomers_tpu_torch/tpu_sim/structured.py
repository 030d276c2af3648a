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
``masked`` calls.

On a mesh (:class:`..parallel.mesh.Mesh`, one rank a block of B
consecutive nodes) the halo exchanges map the local block to the local
inbox with O(B) ppermutes and no all-gather
(:func:`make_sharded_exchange`, :func:`make_sharded_sync_diff`, and
``make_faulted(n_shards=)``'s masked ones): the shift topologies through
the engine's :func:`.engine.sharded_roll` / :func:`.engine.sharded_shift`
(torch ops), the tree through the parent-slice and kids'-partial
multicasts around the kernel pair :func:`.kernels.tree_halo_pack` /
:func:`.kernels.tree_halo_round`.  Each is a :class:`Halo`, bound to a
mesh of ``n_shards`` ranks (:meth:`Halo.bind`).  The nemesis and delay
bundles built with ``n_shards=`` carry theirs too (``make_nemesis``'s
``sharded_exchange`` / ``sharded_src_pc`` / ``sharded_ring_exchange``,
the delay bundles' ``sharded_exchange``): each direction's halo term
masked at its local receivers, the tree's kids masked before the fold
(:func:`tree_halo_terms`), the dup ledger's counts moved by the same
shifts, rolls and parent repeats.

Maelstrom's per-hop latency on this path: :func:`make_delayed`
(per-direction delay classes), :func:`make_edge_delayed` (random
per-edge delays over a small value set), their partition-composed forms
and ``make_nemesis(dir_delays=)`` deliver each direction (or direction
and delay class) from its own slot of the state's payload ring, one ring
kernel launch a round (:func:`ring_terms`); :func:`gather_delays_for`
and :func:`gather_delays_from_rows` give the gather path's equivalent
per-edge delays.

The reference has two lowerings of ``tree_from_kids`` (a lane-roll fold
for mid W and a reshape fold otherwise), pinned bit-identical; the port
keeps the reshape fold only.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import faults, kernels
from ..parallel.topology import grid_cols
from .engine import (active_windows, node_index, resolve_device, send_slot,
                     sharded_roll, sharded_shift, windows_fold)
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


# -- halo exchanges on a mesh -------------------------------------------


@dataclass(frozen=True)
class Halo:
    """A shard-local closure of a halo exchange or sync diff:
    ``fn(mesh, *args)`` over the local blocks of a mesh of ``n_shards``
    ranks, called as ``halo(*args)`` once bound (:meth:`bind`; a
    ``BroadcastSim(mesh=)`` binds its own).  ``flood`` (the tree's) runs
    the fused pure-flood round; the others compose it from the
    exchange."""

    fn: Callable
    n_shards: int
    mesh: object = None
    flood: Callable | None = None

    def bind(self, mesh) -> "Halo":
        from .engine import _check_shards

        _check_shards(mesh, self.n_shards)
        return self if self.mesh is mesh else dataclasses.replace(
            self, mesh=mesh)

    def _bound(self):
        if self.mesh is None:
            raise ValueError("a halo closure runs on a mesh: bind it "
                             "first (Halo.bind, or BroadcastSim(mesh=))")
        return self.mesh

    def __call__(self, *args):
        return self.fn(self._bound(), *args)

    def flood_round(self, received: torch.Tensor, frontier: torch.Tensor,
                    frontier_next: torch.Tensor) -> torch.Tensor:
        """One pure-flood round over the local blocks: ``new = inbox &
        ~received``, ``received |= new`` in place, ``frontier_next[:] =
        new``."""
        if self.flood is not None:
            return self.flood(self._bound(), received, frontier,
                              frontier_next)
        new = self(frontier) & ~received
        received |= new
        frontier_next.copy_(new)
        return frontier_next


def _global_cols(mesh, block: int, device) -> torch.Tensor:
    """(block,) int64 global node ids of the local columns."""
    return node_index(mesh) * block + torch.arange(block, device=device)


def _check_tree_block(block: int, k: int) -> int:
    if block % k != 0 or block < k:
        raise ValueError("tree halo needs k | block")
    return block // k


def _parent_buf(p_local: torch.Tensor, n_shards: int, k: int,
                mesh) -> torch.Tensor:
    """(W, B/k + 1): the slice of its parents' payload a shard receives
    (structured.py:225-252).  Shard d's parents occupy global columns
    [(dB - 1)//k, (dB - 1)//k + B/k], one slice of shard d//k's block
    extended by a 1-column left halo; in multicast round m shard q sends
    destination qk + m its slice, and a shard that no round addresses
    keeps zeros (buf[:, 0] is zero on the shard owning the root)."""
    w, block = p_local.shape
    sub = block // k
    left = (mesh.ppermute(p_local[:, -1:],
                          [(p, p + 1) for p in range(n_shards - 1)])
            if n_shards > 1 else p_local.new_zeros(w, 1))
    buf = None
    for m in range(k):
        sl = (torch.cat([left, p_local[:, :sub]], dim=1) if m == 0
              else p_local[:, m * sub - 1: m * sub + sub])
        rv = mesh.ppermute(sl, [(q, q * k + m) for q in range(n_shards)
                                if q * k + m < n_shards])
        buf = rv if buf is None else buf | rv
    return buf


def _kids_landing(p_local: torch.Tensor, n_shards: int, k: int, mesh,
                  live: torch.Tensor | None = None):
    """(ek (W, B + 1), back (W, 1) or None): the kids' partial ORs a
    shard receives (structured.py:290-327).  Child shard qk + m sends its
    partial (:func:`.kernels.tree_halo_pack`, gated by ``live`` at the
    child columns) to parent shard q, landing at columns [m B/k, m B/k +
    B/k]; column 0 is a partial for the last parent of the shard to the
    left, which gets it back as ``back``."""
    w, block = p_local.shape
    sub = block // k
    partial = kernels.tree_halo_pack(p_local, k, live)
    ek = p_local.new_zeros(w, block + 1)
    for m in range(k):
        rv = mesh.ppermute(partial, [(q * k + m, q) for q in range(n_shards)
                                     if q * k + m < n_shards])
        ek[:, m * sub: m * sub + sub + 1] |= rv
    back = (mesh.ppermute(ek[:, :1],
                          [(p + 1, p) for p in range(n_shards - 1)])
            if n_shards > 1 else None)
    return ek, back


def tree_parent_payload(p_local: torch.Tensor, n: int, n_shards: int,
                        branching: int = 4, mesh=None) -> torch.Tensor:
    """Per-node parent payload of the heap-ordered k-ary tree, local
    block -> local block: out[:, c] = payload[:, (g-1)//k] at global
    node g (zeros at the root).  The from-parent half of
    :func:`tree_sharded_exchange`, and the delivery the tree's sync diff
    rides."""
    w, block = p_local.shape
    k = branching
    _check_tree_block(block, k)
    buf = _parent_buf(p_local, n_shards, k, mesh)
    return torch.cat([buf[:, :1], buf[:, 1:].repeat_interleave(k, dim=1)],
                     dim=1)[:, :block]


def tree_kids_payload(p_local: torch.Tensor, n: int, n_shards: int,
                      branching: int = 4, mesh=None) -> torch.Tensor:
    """Per-node OR of the children's payload, local block -> local block:
    out[:, j] = OR payload[:, kj+1 .. kj+k] (the from-kids half of
    :func:`tree_sharded_exchange`)."""
    _check_tree_block(p_local.shape[1], branching)
    ek, back = _kids_landing(p_local, n_shards, branching, mesh)
    out = ek[:, 1:].clone()
    if back is not None:
        out[:, -1:] |= back
    return out


def tree_sharded_exchange(p_local: torch.Tensor, n: int, n_shards: int,
                          branching: int = 4, mesh=None,
                          live: torch.Tensor | None = None) -> torch.Tensor:
    """The halo exchange of the heap-ordered k-ary tree: local payload
    block -> local inbox block, bit-exact with :func:`tree_exchange`;
    2k + 2 ppermutes of B/k + 1 columns or fewer a round (the 1-column
    halos each way and the k multicasts each way), then
    :func:`.kernels.tree_halo_round`.  ``live``: the block's packed
    parent-edge row (the masked exchange: the parent term gated at the
    receiver, the payload at the child before the fold)."""
    return tree_halo_terms(p_local, p_local, n, n_shards, branching, mesh,
                           live, live)


def tree_halo_terms(p_parent: torch.Tensor, p_kids: torch.Tensor, n: int,
                    n_shards: int, branching: int = 4, mesh=None,
                    live_parent: torch.Tensor | None = None,
                    live_kids: torch.Tensor | None = None) -> torch.Tensor:
    """The halo tree inbox of two local blocks: the from-parent term of
    ``p_parent`` gated at its receivers by the packed row
    ``live_parent``, OR the kids' fold of ``p_kids`` gated at the
    children, before the fold, by ``live_kids`` (None: ungated).  The
    nemesis's two delivery rows, or two ring slots under delays: the
    parent slice is cut from one block, :func:`.kernels.tree_halo_pack`
    packs the other, and :func:`.kernels.tree_halo_round` merges them."""
    w, block = p_parent.shape
    k = branching
    if block * n_shards != n or p_kids.shape != p_parent.shape:
        raise ValueError("node axis must shard evenly")
    _check_tree_block(block, k)
    buf = _parent_buf(p_parent, n_shards, k, mesh)
    ek, back = _kids_landing(p_kids, n_shards, k, mesh, live_kids)
    return kernels.tree_halo_round(buf, ek, back, k, live_parent)


def _tree_flood(mesh, rec, fr, nxt, *, n: int, n_shards: int, k: int):
    # the fused pure-flood round over the halo: the kernel's fused form
    buf = _parent_buf(fr, n_shards, k, mesh)
    ek, back = _kids_landing(fr, n_shards, k, mesh)
    return kernels.tree_halo_round(buf, ek, back, k, received=rec,
                                   frontier_next=nxt)


def grid_sharded_exchange(p_local: torch.Tensor, n: int, n_shards: int,
                          cols: int, mesh=None) -> torch.Tensor:
    """The halo exchange of the row-major grid: ±cols and ±1 zero-fill
    shifts, the ±1 pair masked by global column so rows do not wrap."""
    block = p_local.shape[1]
    if block * n_shards != n:
        raise ValueError("node axis must shard evenly")
    up = sharded_shift(p_local, cols, n_shards, mesh)
    down = sharded_shift(p_local, -cols, n_shards, mesh)
    lf = sharded_shift(p_local, 1, n_shards, mesh)
    rt = sharded_shift(p_local, -1, n_shards, mesh)
    col = _global_cols(mesh, block, p_local.device) % cols
    return (up | down | _mask_cols(lf, col < cols - 1)
            | _mask_cols(rt, col > 0))


def line_sharded_exchange(p_local: torch.Tensor, n: int, n_shards: int,
                          mesh=None) -> torch.Tensor:
    """The halo exchange of the line: ±1 zero-fill shifts."""
    if p_local.shape[1] * n_shards != n:
        raise ValueError("node axis must shard evenly")
    return (sharded_shift(p_local, 1, n_shards, mesh)
            | sharded_shift(p_local, -1, n_shards, mesh))


def _circ_strides(topology: str, kw: dict) -> list:
    return [1] if topology == "ring" else list(kw["strides"])


def _halo_gate(topology: str, n: int, n_shards: int, **kw) -> bool:
    """Whether the topology and shape have a halo decomposition (the
    reference's gates, structured.py:359-415): an even split, k | B for
    the tree, grid rows narrower than a block, B >= 2 for the line."""
    if n_shards < 1 or n % n_shards != 0:
        return False
    block = n // n_shards
    if topology in ("ring", "circulant"):
        return True
    if topology == "tree":
        k = kw.get("branching", 4)
        return block % k == 0 and block >= k
    if topology == "grid":
        return (kw.get("cols") or grid_cols(n)) < block
    if topology == "line":
        return block >= 2
    return False


def make_sharded_exchange(topology: str, n: int, n_shards: int, mesh=None,
                          **kw) -> Halo | None:
    """The halo exchange of a named topology over ``n_shards`` blocks:
    local payload block -> local inbox block with O(block) ppermutes, no
    all-gather.  None where the topology or shape has no halo
    decomposition (the caller then takes the all-gather path): the same
    shapes as the reference.  ``mesh``: bind it now (else
    :meth:`Halo.bind`)."""
    if not _halo_gate(topology, n, n_shards, **kw):
        return None
    flood = None
    if topology in ("ring", "circulant"):
        strides = _circ_strides(topology, kw)

        def fn(mesh, p):
            out = None
            for s in strides:
                term = (sharded_roll(p, s, n, n_shards, mesh)
                        | sharded_roll(p, -s, n, n_shards, mesh))
                out = term if out is None else out | term
            return out
    elif topology == "tree":
        k = kw.get("branching", 4)

        def fn(mesh, p):
            return tree_sharded_exchange(p, n, n_shards, k, mesh)

        flood = functools.partial(_tree_flood, n=n, n_shards=n_shards, k=k)
    elif topology == "grid":
        cols = kw.get("cols") or grid_cols(n)

        def fn(mesh, p):
            return grid_sharded_exchange(p, n, n_shards, cols, mesh)
    else:
        def fn(mesh, p):
            return line_sharded_exchange(p, n, n_shards, mesh)
    halo = Halo(fn, n_shards, flood=flood)
    return halo if mesh is None else halo.bind(mesh)


def has_sharded_exchange(topology: str, n: int, n_shards: int | None,
                         **kw) -> bool:
    """Whether the topology and shape have a halo decomposition."""
    return n_shards is not None and _halo_gate(topology, n, n_shards, **kw)


def make_sharded_sync_diff(topology: str, n: int, n_shards: int, mesh=None,
                           **kw) -> Halo | None:
    """The halo sync diff: local received block -> this shard's () int64
    partial (a uint32) of the per-edge diff volume (the caller
    all-reduces it).  The same gates as :func:`make_sharded_exchange`."""
    if not _halo_gate(topology, n, n_shards, **kw):
        return None
    block = n // n_shards
    if topology in ("ring", "circulant"):
        strides = _circ_strides(topology, kw)

        def fn(mesh, recv):
            out = _zero_diff(recv)
            for s in strides:
                out = out + _dir_diff(sharded_roll(recv, s, n, n_shards,
                                                   mesh), recv)
            return out & MASK32
    elif topology == "tree":
        k = kw.get("branching", 4)

        def fn(mesh, recv):
            parent = tree_parent_payload(recv, n, n_shards, k, mesh)
            return _dir_diff(parent, recv,
                             _global_cols(mesh, block, recv.device) != 0)
    elif topology == "grid":
        cols = kw.get("cols") or grid_cols(n)

        def fn(mesh, recv):
            g = _global_cols(mesh, block, recv.device)
            vert = _dir_diff(sharded_shift(recv, cols, n_shards, mesh),
                             recv, g < n - cols)
            horiz = _dir_diff(sharded_shift(recv, 1, n_shards, mesh), recv,
                              (g < n - 1) & (g % cols < cols - 1))
            return (vert + horiz) & MASK32
    else:
        def fn(mesh, recv):
            return _dir_diff(sharded_shift(recv, 1, n_shards, mesh), recv,
                             _global_cols(mesh, block, recv.device) < n - 1)
    halo = Halo(fn, n_shards)
    return halo if mesh is None else halo.bind(mesh)


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


# the masked halo exchanges (structured.py:765-805): the live rows shard
# with the node axis like the state, (D, ceil(B/32)) packed rows of the
# local block, so every mask lands on local receiver columns (the tree's
# kids mask at child positions is local to the child shard) and the
# masked halo exchange moves what the unmasked one does


def _lv(live: torch.Tensor, d: int, block: int) -> torch.Tensor:
    return kernels.unpack_bits(live[d], block)


def _halo_dir(topology: str, n: int, n_shards: int, wrap_masks: bool = True,
              **kw):
    """``term(mesh, d, x)``: direction d's structured term of the local
    block ``x`` (any integer dtype) over the halo, for the shift
    topologies (the fault direction rows' order).  ``wrap_masks``: the
    grid's left and right terms zeroed at the row ends, as the nemesis
    and delay closures do; the partition bundle's masked closures leave
    that to their exists rows, as the reference's do."""
    block = n // n_shards
    if topology in ("ring", "circulant"):
        strides = _circ_strides(topology, kw)

        def term(mesh, d, x):
            i, back = divmod(d, 2)
            return sharded_roll(x, -strides[i] if back else strides[i], n,
                                n_shards, mesh)
    elif topology == "grid":
        cols = kw.get("cols") or grid_cols(n)
        offs = (cols, -cols, 1, -1)

        def term(mesh, d, x):
            out = sharded_shift(x, offs[d], n_shards, mesh)
            if d < 2 or not wrap_masks:
                return out
            col = _global_cols(mesh, block, x.device) % cols
            return _mask_cols(out, col < cols - 1 if d == 2 else col > 0)
    else:
        def term(mesh, d, x):
            return sharded_shift(x, 1 if d == 0 else -1, n_shards, mesh)
    return term


def _masked_halo_fns(topology: str, n: int, n_shards: int,
                     wrap_masks: bool = False, **kw):
    """``(sex(mesh, p, live), sdf(mesh, r, live))``: the masked halo
    exchange and sync diff over the local packed rows, each direction's
    halo term (:func:`_halo_dir`, ``wrap_masks`` its) masked at its local
    receivers; the tree's row 0 masks both of its terms
    (:func:`tree_sharded_exchange`).
    The diff counts each undirected edge once: the tree's parent rows,
    the even (+s) rows of a circulant, the grid's up and left rows, the
    line's forward row."""
    block = n // n_shards
    if topology == "tree":
        k = kw.get("branching", 4)

        def sex(mesh, p, lv):
            return tree_sharded_exchange(p, n, n_shards, k, mesh,
                                         live=lv[0].contiguous())

        def sdf(mesh, r, lv):
            parent = tree_parent_payload(r, n, n_shards, k, mesh)
            return _dir_diff(parent, r, _lv(lv, 0, block))

        return sex, sdf
    term = _halo_dir(topology, n, n_shards, wrap_masks, **kw)
    if topology in ("ring", "circulant"):
        diff_rows = range(0, 2 * len(_circ_strides(topology, kw)), 2)
    else:
        diff_rows = (0, 2) if topology == "grid" else (0,)

    def sex(mesh, p, lv):
        out = torch.zeros_like(p)
        for d in range(lv.shape[0]):
            out |= _mask_cols(term(mesh, d, p), _lv(lv, d, block))
        return out

    def sdf(mesh, r, lv):
        out = _zero_diff(r)
        for d in diff_rows:
            out = out + _dir_diff(term(mesh, d, r), r, _lv(lv, d, block))
        return out & MASK32

    return sex, sdf


def _masked_diffs(topology: str, n: int, n_shards: int | None = None,
                  **kw):
    """``(df, sdf)``: the masked per-edge sync-diff closure ``df(recv,
    live)`` over packed (D, ceil(N/32)) rows of the degree contract,
    shared by :func:`make_faulted` and :func:`make_nemesis`, and its halo
    form ``sdf`` (a :class:`Halo` over the local rows; None without
    ``n_shards`` or where the halo gates fail).  (None, None) for
    unstructured topologies."""
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
        return None, None
    sdf = None
    if has_sharded_exchange(topology, n, n_shards, **kw):
        sdf = Halo(_masked_halo_fns(topology, n, n_shards, **kw)[1],
                   n_shards)
    return (lambda r, lv: diff(r, kernels.unpack_bits(lv, n))), sdf


@dataclass(frozen=True)
class StructuredFaults:
    """What a words-major BroadcastSim needs to run a partition schedule
    gather-free (built by :func:`make_faulted`):

    - ``exists`` (D, N) bool: static edge existence per direction row;
    - ``same`` (P, D, N) bool: per window and direction, receiver and
      sender in one group;
    - ``exchange(payload, live)`` / ``sync_diff(recv, live)``: the masked
      closures, ``live`` the round's (D, ceil(N/32)) packed rows;
    - ``sharded_exchange`` / ``sharded_sync_diff``: their halo forms
      (:class:`Halo`, over the local block's (D, ceil(B/32)) packed
      rows), None without ``n_shards`` or where the halo gates fail (the
      caller then takes the all-gather path with the full closures)."""

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
    topologies.  ``n_shards``: also the halo closures over that many
    blocks (None where the halo gates fail)."""
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
    df, sdf = _masked_diffs(topology, n, n_shards, **kw)
    sex = None
    if sdf is not None:
        sex = Halo(_masked_halo_fns(topology, n, n_shards, **kw)[0],
                   n_shards)
    return StructuredFaults(exists, same, exchange, df, sex, sdf)


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


# -- the nemesis and delay bundles' halo closures ------------------------
#
# Their halo twins run over the local blocks of a mesh (structured.py:
# 1738-1893 and the sharded branches of :1038-1660 in the reference): the
# masks are the block's own packed rows ((D, ceil(B/32))), the ring the
# state's (L, W, B) block, and each direction's term is the halo
# primitive of the unmasked exchange, masked at its local receiver
# columns, except the tree's child->parent terms, which the pack masks at
# the children before the fold (tree_halo_terms).  The count relocation
# of the dup ledger moves (1, B) int64 counts by the same primitives: a
# pure shift, roll or parent repeat, never an OR of two counts.


def _halo_nem(topology: str, n: int, n_shards: int, **kw):
    """The halo twins of :func:`_nem_closures`: ``(sex(mesh, p, lv),
    sspc(mesh, d, pc))`` over the block's packed delivery rows and its
    (1, B) counts."""
    if topology == "tree":
        k = kw.get("branching", 4)

        def sex(mesh, p, lv):
            return tree_halo_terms(p, p, n, n_shards, k, mesh,
                                   lv[0].contiguous(), lv[1].contiguous())

        def sspc(mesh, d, pc):
            return tree_parent_payload(pc, n, n_shards, k, mesh) if d == 0 \
                else pc

        return sex, sspc
    return (_masked_halo_fns(topology, n, n_shards, True, **kw)[0],
            _halo_dir(topology, n, n_shards, **kw))


def _halo_ring(topology: str, n: int, n_shards: int, **kw):
    """The halo twin of :func:`ring_terms`: ``run(mesh, hist, terms)``
    over the block's (L, W, B) ring, each ``(d, slot, row)`` term's
    packed row (or None) the block's.  The tree takes its parent and kids
    terms a pair a :func:`tree_halo_terms` call (the parent slice cut
    from the parent term's slot, the pack fed from the kids term's)."""
    block = n // n_shards
    if topology == "tree":
        k = kw.get("branching", 4)

        def run(mesh, hist, terms):
            par = [(slot, row) for d, slot, row in terms if d == 0]
            kid = [(slot, row) for d, slot, row in terms if d != 0]
            zero = torch.zeros_like(hist[0])
            out = zero
            for j in range(max(len(par), len(kid))):
                ps, pr = par[j] if j < len(par) else (None, None)
                ks, kr = kid[j] if j < len(kid) else (None, None)
                out = out | tree_halo_terms(
                    zero if ps is None else hist[ps],
                    zero if ks is None else hist[ks], n, n_shards, k, mesh,
                    pr, kr)
            return out

        return run
    term = _halo_dir(topology, n, n_shards, **kw)

    def run(mesh, hist, terms):
        out = torch.zeros_like(hist[0])
        for d, slot, row in terms:
            x = term(mesh, d, hist[slot])
            out |= x if row is None else _mask_cols(
                x, kernels.unpack_bits(row, block))
        return out

    return run


@dataclass(frozen=True)
class StructuredNemesis:
    """What a words-major BroadcastSim needs to run a compiled
    :class:`.faults.FaultPlan` (crash/restart amnesia, loss, dup,
    composed with partition windows) gather-free (built by
    :func:`make_nemesis`):

    - ``arrs``: the mask operand (:class:`.faults.WMNemesisArrays`);
    - ``dir_delays`` / ``ring``: per-direction delays of the delivery
      contract's rows and the ring length (their largest), or None / 1;
    - ``exchange(payload, lv)`` / ``src_pc(d, pc)``: the delivery and
      count-relocation closures (:func:`_nem_closures`);
    - ``sync_diff(recv, rows)``: the masked per-edge diff over the degree
      contract's packed rows, the loss-only server ledger's sync term;
    - ``ring_exchange(hist, terms)``: with ``dir_delays``, the delivery
      from the payload ring (:func:`ring_terms`: one ring kernel over
      each direction's slot and coin row);
    - ``sharded_*``: the halo twins (:class:`Halo`, over a rank's block:
      its packed rows, counts and ring), None without ``n_shards`` or
      where the halo gates fail (the all-gather fallback then runs the
      full closures)."""

    arrs: "faults.WMNemesisArrays"
    dir_delays: tuple | None
    ring: int
    exchange: Callable
    src_pc: Callable
    sharded_exchange: Callable | None
    sharded_src_pc: Callable | None
    sync_diff: Callable | None
    sharded_sync_diff: Callable | None
    ring_exchange: Callable | None = None
    sharded_ring_exchange: Callable | None = None


def make_nemesis(topology: str, n: int, spec: "faults.NemesisSpec",
                 groups: np.ndarray | None = None, dir_delays=None,
                 n_shards: int | None = None,
                 device: str | torch.device | None = None,
                 **kw) -> StructuredNemesis | None:
    """The :class:`StructuredNemesis` bundle: the words-major mask
    decomposition of ``spec`` (a host NemesisSpec: the crash windows must
    be host data to precompute the per-direction masks), composed with an
    optional partition schedule (``groups``: its (P, N) group ids), its
    tensors on ``device`` (default CUDA, as the port's entry points), and
    with optional per-direction ``dir_delays`` (one a delivery-contract
    row: the tree's (down, up)).  Pass it to ``BroadcastSim(nemesis=...,
    fault_plan=spec.compile())``.  None for unstructured topologies.
    ``n_shards``: also the halo closures over that many blocks (None
    where the halo gates fail)."""
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
    dd, ring = None, 1
    if dir_delays is not None:
        dd = tuple(int(x) for x in dir_delays)
        if len(dd) != src.shape[0]:
            raise ValueError(
                f"{topology} takes {src.shape[0]} direction delays, "
                f"got {len(dd)}")
        if any(d < 1 for d in dd):
            raise ValueError("direction delays are rounds >= 1")
        ring = max(dd)
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
            device), n_ids=n)
    ex, spc = _nem_closures(topology, n, **kw)
    df, sdf = _masked_diffs(topology, n, n_shards, **kw)
    sex = sspc = sring = None
    if sdf is not None:
        hex_, hpc = _halo_nem(topology, n, n_shards, **kw)
        sex, sspc = Halo(hex_, n_shards), Halo(hpc, n_shards)
        if dd:
            sring = Halo(_halo_ring(topology, n, n_shards, **kw), n_shards)
    return StructuredNemesis(arrs, dd, ring, ex, spc, sex, sspc, df, sdf,
                             ring_terms(topology, n, **kw) if dd else None,
                             sring)


# -- per-hop latency on the structured path -----------------------------
#
# Maelstrom's latency (reference README.md:16) delays every hop.  Here a
# delay is per direction CLASS (make_delayed: every +s edge of a
# circulant, the tree's parent->child direction, ...) or random per EDGE
# over a small static value set (make_edge_delayed): direction d (or the
# virtual direction (d, v), masked to the receivers whose edge has delay
# v) delivers the payload flooded v - 1 rounds ago, read from the state's
# ring of past payloads.  Every such delivery is one launch of a ring
# kernel (kernels.tree_ring_exchange, kernels.shift_ring_exchange) over a
# table of (direction, ring slot, liveness row) terms; a term whose send
# round t - (v - 1) is below 0 is dropped on the host (nothing was in
# flight yet: the reference's _take_delayed zeros).
#
# Direction-class order (shared with gather_delays_for): tree(k): (parent
# ->child, child->parent); grid: (up, down, left, right); ring: (+1, -1);
# line: (fwd i <- i+1, bwd i <- i-1); circulant: (+s0, -s0, +s1, ...) —
# fault_dir_senders' rows, the tree's first two.


def _take_delayed(hist: torch.Tensor, t: int, delay: int,
                  ring: int) -> torch.Tensor:
    """The payload flooded ``delay - 1`` rounds before ``t`` (zeros before
    round ``delay - 1``: nothing was in flight yet)."""
    slot = send_slot(t, delay, ring)
    return torch.zeros_like(hist[0]) if slot is None else hist[slot]


def ring_terms(topology: str, n: int, **kw):
    """The ring delivery closure ``run(hist, terms) -> inbox`` of a
    topology: ``terms`` lists ``(d, slot, row)``, direction class d's
    structured term of ring slot ``slot`` gated at receivers (the tree's
    child->parent class at child positions, before the fold) by the
    packed (ceil(N/32),) ``row``, or ungated when every row is None.  One
    ring-kernel launch (:func:`.kernels.tree_ring_exchange` for the tree,
    :func:`.kernels.shift_ring_exchange` over the rows of
    :func:`shift_dirs` else); no term gives zeros.  None for unstructured
    topologies."""
    ex = make_exchange(topology, n, **kw)
    if ex is None:
        return None

    def rows_of(terms):
        if not terms or terms[0][2] is None:
            return None
        return torch.stack([row for _, _, row in terms])

    if topology == "tree":
        k = ex.branching

        def run(hist, terms):
            lv = rows_of(terms)
            table = [(slot, kernels.TREE_PARENT if d == 0
                      else kernels.TREE_KIDS, -1 if lv is None else j)
                     for j, (d, slot, _) in enumerate(terms)]
            return kernels.tree_ring_exchange(hist, table, lv, k)

        return run
    dirs = ex.dirs

    def run(hist, terms):
        sel = [d for d, _, _ in terms]
        table = kernels.ShiftDirs(tuple(dirs.offs[d] for d in sel),
                                  tuple(dirs.flags[d] for d in sel),
                                  dirs.cols,
                                  tuple(slot for _, slot, _ in terms))
        return kernels.shift_ring_exchange(hist, table, rows_of(terms))

    return run


def _n_classes(topology: str, n: int, **kw) -> int:
    """Direction classes of the delay contract: the tree's 2, else the
    fault direction rows'."""
    if topology == "tree":
        return 2
    return fault_dir_senders(topology, n, **kw).shape[0]


def _check_dir_delays(topology: str, n: int, dir_delays, **kw) -> tuple:
    dd = tuple(int(x) for x in dir_delays)
    if any(d < 1 for d in dd):
        raise ValueError("direction delays are rounds >= 1")
    want = _n_classes(topology, n, **kw)
    if len(dd) != want:
        raise ValueError(f"{topology} takes {want} direction delays, got "
                         f"{len(dd)}")
    return dd


def gather_delays_for(topology: str, n: int, dir_delays, nbrs,
                      **kw) -> np.ndarray:
    """The (N, D_adj) per-edge delays array (for the gather path)
    equivalent to per-direction-class ``dir_delays`` — the bridge the
    equivalence tests and mixed-path runs use.  Pad slots get 1.  Raises
    when two direction classes alias one physical edge with different
    delays (a circulant stride with 2s ≡ 0 mod n): no per-edge array can
    represent that."""
    snd = fault_dir_senders(topology, n, **kw)
    if topology == "tree":
        k = kw.get("branching", 4)
        if len(dir_delays) != 2:
            raise ValueError("tree takes (down, up) delays")
        row_delays = [dir_delays[0]] + [dir_delays[1]] * k
    else:
        row_delays = list(dir_delays)
    if len(row_delays) != snd.shape[0]:
        raise ValueError(
            f"{topology} takes {snd.shape[0]} direction delays, got "
            f"{len(dir_delays)}")
    return _bridge(snd, [np.full(n, d, np.int32) for d in row_delays], nbrs)


def _bridge(snd: np.ndarray, rows_recv, nbrs) -> np.ndarray:
    """Per-edge delays of an (N, D) table from receiver-side rows (one a
    fault direction row); raises on an aliased edge with two delays."""
    nbrs = np.asarray(nbrs)
    out = np.ones(nbrs.shape, np.int32)
    assigned = np.zeros(nbrs.shape, bool)
    for d, vals in enumerate(rows_recv):
        s = snd[d]
        mask = (nbrs == s[:, None]) & (s[:, None] >= 0)
        want = np.broadcast_to(np.asarray(vals, np.int32)[:, None],
                               nbrs.shape)
        clash = assigned & mask & (out != want)
        if clash.any():
            raise ValueError(
                "direction classes alias the same edge with different "
                f"delays (direction row {d}); per-edge delays cannot "
                "represent this")
        out = np.where(mask, want, out)
        assigned |= mask
    return out


def gather_delays_from_rows(topology: str, n: int, delay_rows, nbrs,
                            **kw) -> np.ndarray:
    """The (N, D_adj) per-edge delays array (the gather path) equivalent
    to per-direction-per-receiver ``delay_rows`` (:func:`make_edge_delayed`'s
    contract).  Pad slots get 1.  Raises when aliased direction classes
    (circulant 2s ≡ 0 mod n) carry different delays for one edge."""
    snd = fault_dir_senders(topology, n, **kw)
    dr = np.asarray(delay_rows, np.int64)
    if topology == "tree":
        k = kw.get("branching", 4)
        if dr.shape != (2, n):
            raise ValueError("tree takes (2, N) delay rows")
        # row 0 is receiver-side (the child); fault rows 1..k (child
        # slot j at PARENT positions) read the up-delay at the child
        rows_recv = [dr[0]]
        for j in range(k):
            c = snd[1 + j]
            rows_recv.append(np.where(c >= 0, dr[1][np.clip(c, 0, n - 1)],
                                      1))
    else:
        if dr.shape != (snd.shape[0], n):
            raise ValueError(
                f"{topology} takes ({snd.shape[0]}, N) delay rows")
        rows_recv = list(dr)
    return _bridge(snd, rows_recv, nbrs)


@dataclass(frozen=True)
class StructuredDelays:
    """Delayed structured delivery (from :func:`make_delayed`):
    ``dir_delays`` per direction class (rounds >= 1), ``ring`` = the
    largest, ``exchange(history, t)`` the (W, N) inbox from the (L, W, N)
    ring; ``sharded_exchange(history, t)`` its halo twin over a rank's
    (L, W, B) ring (:class:`Halo`), None without ``n_shards`` or where
    the halo gates fail."""

    dir_delays: tuple
    ring: int
    exchange: Callable
    sharded_exchange: Callable | None = None


def _delayed_impl(topology: str, n: int, dir_delays, n_shards=None, **kw):
    """The per-direction-class delivery shared by :func:`make_delayed`
    and :func:`make_delayed_faulted`: ``(dd, ex, sex)``, ``ex(hist, t,
    lv)`` with ``lv`` None (no partitions) or a {delay: (D, ceil(N/32))
    packed liveness} dict evaluated at each delay's send round (the fault
    contract's rows: the tree's row 0 gates both of its classes, at
    receivers and before the fold); ``sex(mesh, hist, t, lv)`` its halo
    twin over a block's ring and rows (None without ``n_shards`` or where
    the halo gates fail).  None for unstructured topologies."""
    run = ring_terms(topology, n, **kw)
    if run is None:
        return None
    dd = _check_dir_delays(topology, n, dir_delays, **kw)
    ring = max(dd)
    mask_row = (lambda d: 0) if topology == "tree" else (lambda d: d)

    def terms(t, lv):
        out = []
        for d, v in enumerate(dd):
            slot = send_slot(t, v, ring)
            if slot is not None:
                out.append((d, slot, None if lv is None
                            else lv[v][mask_row(d)]))
        return out

    def ex(hist, t, lv):
        return run(hist, terms(t, lv))

    sex = None
    if has_sharded_exchange(topology, n, n_shards, **kw):
        hrun = _halo_ring(topology, n, n_shards, **kw)

        def sex(mesh, hist, t, lv):
            return hrun(mesh, hist, terms(t, lv))

    return dd, ex, sex


def make_delayed(topology: str, n: int, dir_delays,
                 n_shards: int | None = None,
                 **kw) -> StructuredDelays | None:
    """The :class:`StructuredDelays` bundle.  ``dir_delays`` length: tree
    2, grid 4, ring / line 2, circulant 2 * len(strides).  None for
    unstructured topologies.  Two direction classes that are one physical
    edge (a circulant stride with 2s ≡ 0 mod n) both deliver: the edge
    carries both delays (:func:`gather_delays_for` raises there)."""
    impl = _delayed_impl(topology, n, dir_delays, n_shards, **kw)
    if impl is None:
        return None
    dd, ex, sex = impl
    return StructuredDelays(
        dd, max(dd), lambda h, t: ex(h, t, None),
        None if sex is None else Halo(
            lambda mesh, h, t: sex(mesh, h, t, None), n_shards))


@dataclass(frozen=True)
class FaultedDelayed:
    """Per-direction delay classes under partition windows (from
    :func:`make_delayed_faulted`): each class delivers its past payload
    masked by the window liveness AT ITS SEND ROUND.
    ``exchange(history, t, live_at)`` takes the sim's ``live_at(t') ->
    (D, ceil(N/32))`` packed rows (exists AND same-group under the
    windows active at t') and evaluates it once a distinct delay;
    ``exists`` / ``same`` follow :class:`StructuredFaults`, and
    ``sync_diff(recv, live)`` is the ledger's masked diff;
    ``sharded_exchange`` / ``sharded_sync_diff`` their halo twins over a
    rank's block (``live_at`` then gives the block's rows), None without
    ``n_shards`` or where the halo gates fail."""

    exists: np.ndarray
    same: np.ndarray
    dir_delays: tuple
    ring: int
    exchange: Callable
    sharded_exchange: Callable | None = None
    sync_diff: Callable | None = None
    sharded_sync_diff: Callable | None = None


def make_delayed_faulted(topology: str, n: int, dir_delays,
                         groups: np.ndarray, n_shards: int | None = None,
                         **kw) -> FaultedDelayed | None:
    """Per-direction delay classes composed with a partition schedule
    (``groups``: its (P, N) group ids), gather-free; masks follow
    :func:`fault_masks`, delivery :func:`make_delayed`'s.  None for
    unstructured topologies."""
    masks = fault_masks(topology, n, groups, **kw)
    impl = _delayed_impl(topology, n, dir_delays, n_shards, **kw)
    if masks is None or impl is None:
        return None
    exists, same = masks
    dd, ex_impl, sex_impl = impl

    def lv_by_delay(live_at, t):
        # one liveness a distinct delay, at its send round
        return {v: live_at(t - (v - 1)) for v in sorted(set(dd))
                if t - (v - 1) >= 0}

    def exchange(hist, t, live_at):
        return ex_impl(hist, t, lv_by_delay(live_at, t))

    df, sdf = _masked_diffs(topology, n, n_shards, **kw)
    sex = None
    if sex_impl is not None:
        sex = Halo(lambda mesh, hist, t, live_at: sex_impl(
            mesh, hist, t, lv_by_delay(live_at, t)), n_shards)
    return FaultedDelayed(exists, same, dd, max(dd), exchange, sex, df,
                          sdf)


# Per-EDGE random delays.  Delays take values from a small static set, so
# a random (D, N) per-direction-per-receiver delay matrix splits into one
# receiver mask ``rows[d] == v`` a (direction, delay) pair: delivery is
#
#   inbox = OR over (d, v) of mask_cols(term_d(history @ v), rows[d] == v)
#
# — D x |delay set| structured terms a round, no random access, one ring
# kernel launch (splitting past 16 table rows).  Row contract: grid /
# ring / line / circulant follow the fault direction rows (receiver
# side); the tree takes TWO rows, both at CHILD positions: row 0 the
# parent->child edge's delay (receiver the child), row 1 the child->
# parent edge's (receiver the parent, masked before the fold).


def _ed_mask(rows, wl, d: int, v: int):
    """The (direction, delay class) receiver mask of the edge-delayed
    delivery, as packed rows: ``rows`` the bundle's class row of (d, v)
    (its edges of delay v), ANDed, when a window-liveness dict ``wl``
    rides along, with direction d's partition liveness at class v's send
    round (None there: no window active)."""
    if wl is None or wl.get(v) is None:
        return rows
    return rows & wl[v][d]


@dataclass(frozen=True)
class EdgeDelays:
    """Per-edge random delayed structured delivery (from
    :func:`make_edge_delayed`): ``delay_rows`` (D, N) int32 (the row
    contract above), ``delay_set`` its distinct values, ``ring`` the
    largest, ``classes`` the (d, v) pairs with a receiver (the host-side
    skip: constant rows cost exactly :func:`make_delayed`), and
    ``exchange(history, t, class_rows, wl=None)`` over
    :meth:`class_rows`' packed masks and an optional {delay: packed
    window liveness | None} dict; ``sharded_exchange`` its halo twin
    (:class:`Halo`) over a rank's ring and class rows (:meth:`class_rows`
    of its columns), None without ``n_shards`` or where the halo gates
    fail."""

    delay_rows: np.ndarray
    delay_set: tuple
    ring: int
    classes: tuple
    exchange: Callable
    sharded_exchange: Callable | None = None

    def class_rows(self, device, cols: slice = slice(None)) -> torch.Tensor:
        """(len(classes), ceil(N/32)) packed ``delay_rows[d] == v`` of each
        (d, v) of :attr:`classes`, on ``device``; ``cols``: a rank's
        block of the columns (then packed over the block)."""
        return kernels.pack_bits(torch.from_numpy(np.ascontiguousarray(
            np.stack([self.delay_rows[d][cols] == v
                      for d, v in self.classes])))).to(device)


def make_edge_delayed(topology: str, n: int, delay_rows,
                      n_shards: int | None = None,
                      **kw) -> EdgeDelays | None:
    """The :class:`EdgeDelays` bundle for random per-edge delays over a
    small static value set: ``delay_rows`` (D, N) ints >= 1, D = 2 for
    the tree, else the fault direction rows' count.  None for
    unstructured topologies.  Aliased direction classes (circulant 2s ≡ 0
    mod n) both deliver (:func:`gather_delays_from_rows` raises there).
    ``n_shards``: also the halo closure over that many blocks."""
    run = ring_terms(topology, n, **kw)
    if run is None:
        return None
    dr = np.asarray(delay_rows, np.int32)
    want = (_n_classes(topology, n, **kw), n)
    if dr.shape != want:
        raise ValueError(f"{topology} takes {want} delay rows, got "
                         f"{dr.shape}")
    if dr.min() < 1:
        raise ValueError("edge delays are rounds >= 1")
    delay_set = tuple(int(v) for v in np.unique(dr))
    ring = max(delay_set)
    # host-side presence: a (d, v) pair with no receiver is never a term
    classes = tuple((d, v) for v in delay_set for d in range(dr.shape[0])
                    if (dr[d] == v).any())

    def terms(t, class_rows, wl):
        out = []
        for j, (d, v) in enumerate(classes):
            slot = send_slot(t, v, ring)
            if slot is not None:
                out.append((d, slot, _ed_mask(class_rows[j], wl, d, v)))
        return out

    def exchange(hist, t, class_rows, wl=None):
        return run(hist, terms(t, class_rows, wl))

    sex = None
    if has_sharded_exchange(topology, n, n_shards, **kw):
        hrun = _halo_ring(topology, n, n_shards, **kw)

        def halo_ex(mesh, hist, t, class_rows, wl=None):
            return hrun(mesh, hist, terms(t, class_rows, wl))

        sex = Halo(halo_ex, n_shards)
    return EdgeDelays(dr, delay_set, ring, classes, exchange, sex)


@dataclass(frozen=True)
class FaultedEdgeDelays(EdgeDelays):
    """Random per-edge delays composed with partition windows (from
    :func:`make_edge_delayed_faulted`): Maelstrom's default latency and
    partitions together (reference README.md:16, 18).  Each (direction,
    delay class) term is also masked by its direction's window liveness
    at that class's send round (``live_by_delay(del_same, pstarts, pends,
    t)``: one evaluation a distinct delay).  ``exists`` / ``same`` follow
    the fault direction-row contract (the ledger's live degree and masked
    diff, ``sync_diff``); ``del_same`` (P, D_rows, N) is the delivery
    rows' twin (the tree's two child-position rows both read the parent
    edge's window)."""

    exists: np.ndarray | None = None
    same: np.ndarray | None = None
    del_same: np.ndarray | None = None
    live_by_delay: Callable | None = None
    sync_diff: Callable | None = None
    sharded_sync_diff: Callable | None = None


def make_edge_delayed_faulted(topology: str, n: int, delay_rows,
                              groups: np.ndarray,
                              n_shards: int | None = None,
                              **kw) -> FaultedEdgeDelays | None:
    """Random per-edge delays composed with a partition schedule
    (``groups``: its (P, N) group ids), gather-free; delivery follows
    :func:`make_edge_delayed`, masks :func:`fault_masks`.  None for
    unstructured topologies."""
    ed = make_edge_delayed(topology, n, delay_rows, n_shards, **kw)
    if ed is None:
        return None
    exists, same = fault_masks(topology, n, groups, **kw)
    if topology == "tree":
        # both delivery rows are the parent edge at child positions
        del_same = np.concatenate([same[:, :1], same[:, :1]], axis=1)
    else:
        del_same = same
    delay_set = ed.delay_set

    def live_by_delay(dsame, pstarts, pends, t):
        # one window liveness a distinct delay at its send round, shared
        # by the directions (None: no window active then)
        out = {}
        for v in delay_set:
            tt = t - (v - 1)
            if tt >= 0 and active_windows(pstarts, pends, tt):
                out[v] = windows_fold(pstarts, pends, tt,
                                      lambda w, lv: lv & dsame[w],
                                      torch.full_like(dsame[0], -1))
        return out

    df, sdf = _masked_diffs(topology, n, n_shards, **kw)
    return FaultedEdgeDelays(
        ed.delay_rows, delay_set, ed.ring, ed.classes, ed.exchange,
        ed.sharded_exchange, exists=exists, same=same, del_same=del_same,
        live_by_delay=live_by_delay, sync_diff=df, sharded_sync_diff=sdf)
