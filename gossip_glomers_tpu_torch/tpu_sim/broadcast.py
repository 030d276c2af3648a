"""Broadcast (challenge 3) on PyTorch: the words-major flood simulator.

The port of gossip_glomers_tpu/tpu_sim/broadcast.py's words-major,
single-device path.  Each node keeps a ``received`` bitset and a
``frontier`` bitset (the values learned last round); one round delivers
every node's frontier to its topology neighbors and keeps what is new:

    new = exchange(frontier) & ~received
    received |= new
    frontier  = new

and every ``sync_every`` rounds the payload is the full received set (the
reference's push-pull anti-entropy).

State layout: ``received`` and ``frontier`` are (W, N) ``torch.int32``,
bit-identical to the reference's uint32 words (torch's uint32 lacks
``~``, ``>>`` and comparisons on the CPU).  The ledgers ``msgs`` and
``srv_msgs`` are () int64 tensors holding uint32 values: every add is
masked to 32 bits, so they wrap exactly where the reference's uint32
ledgers wrap.  ``t`` is a host int: the round schedule (sync waves, the
t == 0 ledger coefficient) is host control flow in eager PyTorch.

Modes not ported yet raise: the node-major gather path (``exchange=None``),
meshes, partitions and every fault or delay mode (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import kernels
from .engine import fori_rounds, stepwise_converge, while_converge
from .structured import MASK32

WORD = 32

_UNPORTED = ("mesh", "parts", "faulted", "delays", "delayed", "edge_delayed",
             "fault_plan", "nemesis", "union_block", "dcn_mode",
             "sharded_exchange", "sharded_sync_diff")


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


@dataclasses.dataclass
class BroadcastState:
    received: torch.Tensor            # (W, N) int32
    frontier: torch.Tensor            # (W, N) int32
    t: int                            # round counter
    msgs: torch.Tensor                # () int64, uint32 value-message ledger
    # reference-accounted server-message ledger (() int64 holding a
    # uint32), or None when srv_ledger is off
    srv_msgs: torch.Tensor | None = None


def _words_major(a: np.ndarray) -> torch.Tensor:
    """(N, W) uint32 numpy -> a fresh (W, N) int32 CPU tensor (always a
    copy: the loops update received in place)."""
    return torch.from_numpy(
        np.array(np.asarray(a, np.uint32).T, order="C").view(np.int32))


def state_from_numpy(received: np.ndarray, frontier: np.ndarray, t: int,
                     msgs: int, srv_msgs: int | None,
                     device: str | torch.device) -> BroadcastState:
    """A port state from the reference's values as numpy: node-major
    (N, W) uint32 bitsets (the JAX words-major arrays transposed) and
    integer ledgers."""
    def bits(a: np.ndarray) -> torch.Tensor:
        return _words_major(a).to(device)

    def ledger(v: int) -> torch.Tensor:
        return torch.tensor(int(v) & MASK32, dtype=torch.int64,
                            device=device)

    return BroadcastState(received=bits(received), frontier=bits(frontier),
                          t=int(t), msgs=ledger(msgs),
                          srv_msgs=None if srv_msgs is None
                          else ledger(srv_msgs))


def state_to_numpy(state: BroadcastState):
    """(received, frontier, t, msgs, srv_msgs) with node-major (N, W)
    uint32 bitsets and int ledgers — the inverse of
    :func:`state_from_numpy`."""
    def bits(x: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(x.cpu().numpy().view(np.uint32).T)

    return (bits(state.received), bits(state.frontier), state.t,
            int(state.msgs),
            None if state.srv_msgs is None else int(state.srv_msgs))


def _round_wm(state: BroadcastState, *, deg: torch.Tensor, sync_every: int,
              exchange: Callable[[torch.Tensor], torch.Tensor],
              sync_diff: Callable[[torch.Tensor], torch.Tensor] | None = None,
              ) -> BroadcastState:
    """Words-major round (plain mode of the reference's ``_round_wm``).
    ``deg`` is the per-node topology degree (int64); every edge is live,
    so the live degree equals it."""
    t = state.t
    is_sync = t % sync_every == 0 and t > 0
    payload = state.received if is_sync else state.frontier
    pc = kernels.col_popcount(payload)
    sent = _dot32(pc, deg)
    srv = None
    if state.srv_msgs is not None:
        pcf = kernels.col_popcount(state.frontier) if is_sync else pc
        d2 = 2 * deg                          # d + ld
        coef = d2 if t == 0 else (d2 - 2).clamp(min=0)
        srv = state.srv_msgs + _dot32(pcf, coef)
        if is_sync:
            srv = srv + wrap32(d2.sum()) + 2 * sync_diff(state.received)
        srv = wrap32(srv)
    new = exchange(payload) & ~state.received
    return BroadcastState(received=state.received | new, frontier=new,
                          t=t + 1, msgs=wrap32(state.msgs + sent),
                          srv_msgs=srv)


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


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on CUDA unless the caller passes a
    device; with none given and no CUDA present they raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on a GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    return torch.device(device)


class BroadcastSim:
    """Round-synchronous words-major broadcast simulator on one device
    (the single-device, fault-free subset of the reference's
    ``BroadcastSim`` with a structured ``exchange``)."""

    def __init__(self, nbrs: np.ndarray, *, n_values: int,
                 sync_every: int = 8, exchange=None,
                 sync_diff: Callable[[torch.Tensor], torch.Tensor]
                 | None = None,
                 srv_ledger: bool = True,
                 device: str | torch.device | None = None,
                 **unported) -> None:
        """``exchange``: a structured exchange from
        :func:`.structured.make_exchange` (it carries the fused flood
        round).  ``sync_diff``: the matching
        :func:`.structured.make_sync_diff` closure, needed for the
        server ledger.  ``device``: where the state lives (default CUDA;
        raises if there is none).  Reference modes not ported yet
        (``mesh``, ``parts``, faults, delays, ...) raise when given."""
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value is not None:
                raise NotImplementedError(
                    f"BroadcastSim({name}=...) is not ported to PyTorch "
                    "yet (ROADMAP.md Queue A)")
        if exchange is None:
            raise NotImplementedError(
                "the node-major adjacency-gather path (exchange=None) is "
                "not ported yet (ROADMAP.md Queue A item 5): pass a "
                "structured exchange")
        if not hasattr(exchange, "flood_round"):
            raise TypeError("exchange must come from "
                            "structured.make_exchange")
        self.device = resolve_device(device)
        self.n_values = n_values
        self.sync_every = sync_every
        self.exchange = exchange
        self.sync_diff = sync_diff
        self._srv_on = srv_ledger and sync_diff is not None
        self._host_deg = (nbrs >= 0).sum(axis=1).astype(np.int64)
        self.deg = torch.as_tensor(self._host_deg, device=self.device)
        self._fixed = {}

    # -- construction ----------------------------------------------------

    def init_state(self, inject: np.ndarray) -> BroadcastState:
        received = _words_major(inject).to(self.device)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return BroadcastState(received=received, frontier=received.clone(),
                              t=0, msgs=zero,
                              srv_msgs=zero.clone() if self._srv_on
                              else None)

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

    def step(self, state: BroadcastState) -> BroadcastState:
        return _round_wm(state, deg=self.deg, sync_every=self.sync_every,
                         exchange=self.exchange,
                         sync_diff=self.sync_diff if self._srv_on else None)

    def converged(self, state: BroadcastState,
                  target: torch.Tensor) -> bool:
        return bool((state.received == target[:, None]).all())

    def run(self, inject: np.ndarray, *, max_rounds: int = 1 << 16,
            check_every: int = 1) -> tuple[BroadcastState, int]:
        """Step until every node holds every injected value (or
        ``max_rounds``); runs at least one round.  Returns (final state,
        rounds run)."""
        target = self.target_bits(inject)
        return stepwise_converge(
            self.step, lambda s: self.converged(s, target),
            self.init_state(inject), max_rounds, check_every)

    def run_fused(self, inject: np.ndarray, *, max_rounds: int = 1 << 16,
                  ) -> tuple[BroadcastState, int]:
        """The while-converge runner: convergence is tested before the
        first round and after each.  Returns (final state, rounds run)."""
        state, target = self.stage(inject)
        final = while_converge(self.step,
                               lambda s: self.converged(s, target), state,
                               max_rounds)
        return final, final.t

    def _build_fixed(self, rounds: int, donate: bool):
        """(runner, flood parts | None) for exactly ``rounds`` rounds.
        The pure-flood specialization (kernel loop + closed-form ledger)
        applies when no sync wave fires within the trip count and the
        server ledger is off — the reference's ``flood_ok`` gate with
        every fault mode absent."""
        flood_ok = not self._srv_on and 0 < rounds <= self.sync_every
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

    # -- readout ---------------------------------------------------------

    def received_node_major(self, state: BroadcastState) -> np.ndarray:
        """(N, W) uint32 received bitset."""
        return state.received.cpu().numpy().view(np.uint32).T

    def server_msgs(self, state: BroadcastState) -> int:
        """Reference-accounted server-to-server message total."""
        if state.srv_msgs is None:
            raise ValueError(
                "server-message ledger is off: srv_ledger=False or no "
                "sync_diff closure (structured.make_sync_diff)")
        return int(state.srv_msgs)
