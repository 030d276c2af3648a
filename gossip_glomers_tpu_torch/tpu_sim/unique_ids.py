"""Globally unique ID generation (Gossip Glomers challenge 2) on PyTorch:
the port of gossip_glomers_tpu/tpu_sim/unique_ids.py.

The reference node derives uniqueness from UUIDv1 = (timestamp, node id,
clock sequence), with no coordination.  Here an ID is the packed triple
``(round t, node index, per-round sequence number)``, unique by
construction across the cluster with zero messages.  One round mints up
to G ids at every node in one pass of torch ops (no kernel).  On a mesh
(``UniqueIdsSim(mesh=)``, a :class:`..parallel.mesh.Mesh`) each rank
mints for its block of the nodes under their global ids, from the full
(N,) counts it is given, and makes no collective.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .engine import (check_mesh, collectives, node_index, node_shards,
                     refuse_words,
                     resolve_device)


class UniqueIdsState(NamedTuple):
    t: int                 # round (the "timestamp")
    minted: torch.Tensor   # (N,) int32 — ids minted per node (ever)


class UniqueIdsSim:
    """Batched ID mint.  ``step(state, counts)`` mints ``counts[n]`` ids
    at node n and returns (new_state, ids), ids (N, G, 3) int32 [t, node,
    seq] with -1 padding beyond counts (on a mesh the rank's block of
    both)."""

    def __init__(self, n_nodes: int, *, max_per_round: int = 4, mesh=None,
                 device: str | torch.device | None = None) -> None:
        if mesh is not None:
            check_mesh(mesh)
            refuse_words(mesh, "UniqueIdsSim")
            if n_nodes % node_shards(mesh):
                raise ValueError(f"{n_nodes} nodes do not shard evenly "
                                 f"over {node_shards(mesh)} ranks")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_nodes = n_nodes
        self.max_per_round = max_per_round
        self._block = n_nodes if mesh is None else n_nodes // node_shards(mesh)
        self._row0 = 0 if mesh is None else node_index(mesh) * self._block
        self._row_ids = collectives(self._block, mesh,
                                    device=self.device).row_ids

    def init_state(self) -> UniqueIdsState:
        return UniqueIdsState(t=0, minted=torch.zeros(
            (self._block,), dtype=torch.int32, device=self.device))

    def step(self, state: UniqueIdsState, counts
             ) -> tuple[UniqueIdsState, torch.Tensor]:
        c = np.asarray(counts, np.int32)[self._row0:self._row0 + self._block]
        c = torch.as_tensor(np.ascontiguousarray(c)).to(self.device)
        seq = torch.arange(self.max_per_round, dtype=torch.int32,
                           device=self.device)[None, :]          # (1, G)
        mint = seq < c[:, None]                                 # (N, G)
        ids = torch.stack(
            [torch.full(mint.shape, state.t, dtype=torch.int32,
                        device=self.device),
             self._row_ids[:, None].expand(mint.shape),
             seq.expand(mint.shape)], dim=-1)
        ids = torch.where(mint[..., None], ids, -1)
        return UniqueIdsState(t=state.t + 1, minted=state.minted + c), ids

    @staticmethod
    def format_ids(ids) -> list[str]:
        """Flatten a round's (N, G, 3) id block to wire-format strings
        ("t-node-seq", the analogue of the uuid string in
        generate_ok.id)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        arr = np.asarray(ids).reshape(-1, 3)
        return [f"{t:08x}-{n:08x}-{s:04x}"
                for t, n, s in arr if t >= 0]
