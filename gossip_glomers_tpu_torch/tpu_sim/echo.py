"""Echo (Gossip Glomers challenge 1) on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/echo.py, off-mesh.

The reference echo node replies to each request with the same body, its
``type`` rewritten to ``echo_ok``.  Batched, that is the identity over an
(N, B) payload block with a request/reply message ledger: one pass of
torch ops (no kernel).  A ``mesh`` raises (ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .engine import resolve_device
from .kernels import MASK32


class EchoState(NamedTuple):
    t: int
    msgs: torch.Tensor     # () int64 — request + reply count, a uint32


class EchoSim:
    def __init__(self, n_nodes: int, *, mesh=None,
                 device: str | torch.device | None = None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "EchoSim(mesh=...) is not ported to PyTorch yet "
                "(ROADMAP.md Queue A item 10)")
        self.device = resolve_device(device)
        self.n_nodes = n_nodes

    def init_state(self) -> EchoState:
        return EchoState(t=0, msgs=torch.zeros((), dtype=torch.int64,
                                               device=self.device))

    def step(self, state: EchoState, payload, valid
             ) -> tuple[EchoState, torch.Tensor]:
        p = torch.as_tensor(np.asarray(payload, np.int32)).to(self.device)
        v = torch.as_tensor(np.asarray(valid, bool)).to(self.device)
        replies = torch.where(v, p, -1)
        msgs = (state.msgs + 2 * v.sum()) & MASK32
        return EchoState(t=state.t + 1, msgs=msgs), replies
