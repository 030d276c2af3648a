"""Echo (Gossip Glomers challenge 1) on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/echo.py.

The reference echo node replies to each request with the same body, its
``type`` rewritten to ``echo_ok``.  Batched, that is the identity over an
(N, B) payload block with a request/reply message ledger: one pass of
torch ops (no kernel).  On a mesh (``EchoSim(mesh=)``, a
:class:`..parallel.mesh.Mesh`) each rank replies for its block of the
nodes; the ledger counts the full (N, B) ``valid`` every rank is given,
so it is replicated without a collective.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .engine import (check_mesh, node_index, node_shards, refuse_words,
                     resolve_device)
from .kernels import MASK32


class EchoState(NamedTuple):
    t: int
    msgs: torch.Tensor     # () int64 — request + reply count, a uint32


class EchoSim:
    def __init__(self, n_nodes: int, *, mesh=None,
                 device: str | torch.device | None = None) -> None:
        if mesh is not None:
            check_mesh(mesh)
            refuse_words(mesh, "EchoSim")
            if n_nodes % node_shards(mesh):
                raise ValueError(f"{n_nodes} nodes do not shard evenly "
                                 f"over {node_shards(mesh)} ranks")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_nodes = n_nodes
        block = n_nodes if mesh is None else n_nodes // node_shards(mesh)
        row0 = 0 if mesh is None else node_index(mesh) * block
        self._rows = slice(row0, row0 + block)

    def init_state(self) -> EchoState:
        return EchoState(t=0, msgs=torch.zeros((), dtype=torch.int64,
                                               device=self.device))

    def step(self, state: EchoState, payload, valid
             ) -> tuple[EchoState, torch.Tensor]:
        """The replies to the (N, B) requests (the rank's block of them on
        a mesh), -1 where ``valid`` is false."""
        v = torch.as_tensor(np.asarray(valid, bool)).to(self.device)
        p = torch.as_tensor(np.ascontiguousarray(
            np.asarray(payload, np.int32)[self._rows])).to(self.device)
        replies = torch.where(v[self._rows], p, -1)
        msgs = (state.msgs + 2 * v.sum()) & MASK32
        return EchoState(t=state.t + 1, msgs=msgs), replies
