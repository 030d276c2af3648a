"""Structured-topology neighbor exchange on words-major (W, N) bitsets.

The port of gossip_glomers_tpu/tpu_sim/structured.py for the k-ary tree:
node i's parent is (i-1)//k — a repeat by k — and node p's children are
kp+1..kp+k — a pad, a (W, N/k, k) view and an OR over the last axis.
These functions are the plain PyTorch versions; :func:`make_exchange`
and :func:`make_sync_diff` hand the simulator closures that run the
hand-written kernels of :mod:`.kernels` on a CUDA device.

The reference has two lowerings of ``tree_from_kids`` (a lane-roll fold
for mid W and a reshape fold otherwise), pinned bit-identical; the port
keeps the reshape fold only.  Other named topologies (grid, ring, line,
circulant) are not ported yet: see ROADMAP.md Queue A.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import kernels

MASK32 = 0xFFFFFFFF


def _unported(topology: str) -> NotImplementedError:
    return NotImplementedError(
        f"topology {topology!r} is not ported to PyTorch yet: only 'tree' "
        "is (ROADMAP.md Queue A lists the other structured exchanges)")


def tree_from_parent(payload: torch.Tensor,
                     branching: int = 4) -> torch.Tensor:
    """inbox[:, i] = payload[:, (i-1)//k] for i >= 1 (zeros at the
    root) — the parent->child half of :func:`tree_exchange`."""
    w, n = payload.shape
    k = branching
    n_parents = (n - 1 + k - 1) // k
    fp = payload[:, :n_parents].repeat_interleave(k, dim=1)[:, :n - 1]
    return torch.cat([payload.new_zeros(w, 1), fp], dim=1)


def tree_from_kids(payload: torch.Tensor,
                   branching: int = 4) -> torch.Tensor:
    """inbox[:, p] = OR payload[:, kp+1 .. kp+k] — the child->parent
    half of :func:`tree_exchange` (zeros for p >= n_parents; the last
    parent may have fewer than k children)."""
    w, n = payload.shape
    k = branching
    n_parents = (n - 1 + k - 1) // k
    m = n_parents * k
    kids = torch.cat([payload[:, 1:], payload.new_zeros(w, m - (n - 1))],
                     dim=1)
    fk = functools.reduce(torch.bitwise_or,
                          kids.view(w, n_parents, k).unbind(dim=2))
    return torch.cat([fk, payload.new_zeros(w, n - n_parents)], dim=1)


def tree_exchange(payload: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """inbox for the k-ary tree of parallel/topology.py::tree — i's
    neighbors are parent (i-1)//k and children ki+1..ki+k."""
    if payload.shape[1] == 1:
        return torch.zeros_like(payload)
    return (tree_from_parent(payload, branching)
            | tree_from_kids(payload, branching))


def _dir_diff(term: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """() int64 holding a uint32 — both directed diffs of each edge,
    computed at the receiving end, summed mod 2^32."""
    per = (kernels.col_popcount(term & ~recv)
           + kernels.col_popcount(recv & ~term))
    return per.sum(dtype=torch.int64) & MASK32


def tree_sync_diff(recv: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """() int64 holding a uint32 — the anti-entropy pairwise diff volume
    over every tree edge (parent, child)."""
    w, n = recv.shape
    k = branching
    if n == 1:
        return torch.zeros((), dtype=torch.int64, device=recv.device)
    n_parents = (n - 1 + k - 1) // k
    parent = recv[:, :n_parents].repeat_interleave(k, dim=1)[:, :n - 1]
    return _dir_diff(parent, recv[:, 1:].contiguous())


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


def make_exchange(topology: str, n: int, **kw) -> TreeExchange:
    """Exchange closure for a named topology (tree only in the port)."""
    if topology == "tree":
        return TreeExchange(kw.get("branching", 4))
    raise _unported(topology)


def make_sync_diff(topology: str, n: int, **kw):
    """Single-device per-edge sync-diff closure ``diff(recv) -> ()
    int64`` (tree only in the port)."""
    if topology == "tree":
        k = kw.get("branching", 4)
        return lambda r: tree_sync_diff(r, k)
    raise _unported(topology)
