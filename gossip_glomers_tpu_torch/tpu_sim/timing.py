"""Benchmark timing for tree-flood convergence runs on a CUDA device.

The port of gossip_glomers_tpu/tpu_sim/timing.py's tree path: run
exactly the convergence round count (host-computed, :func:`discover_rounds`)
as the fixed-trip pure-flood loop (``BroadcastSim.build_fixed``'s flood
specialization, whose ledger is recovered in closed form after the loop)
and time the loop alone with CUDA events.  Staging stays off the clock;
each sample re-stages, because the loop updates ``received`` in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.topology import to_padded_neighbors, tree
from .broadcast import BroadcastSim, make_inject
from .kernels import col_popcount
from .structured import make_exchange, make_sync_diff


def _tree_only(topology: str) -> None:
    if topology != "tree":
        raise NotImplementedError(
            f"topology {topology!r} is not ported to PyTorch yet: only "
            "'tree' is (ROADMAP.md Queue A)")


def _nbrs_for(topology: str, n: int, **kw) -> np.ndarray:
    _tree_only(topology)
    return to_padded_neighbors(tree(n, branching=kw.get("branching", 4)))


def structured_sim(topology: str, n: int, n_values: int, *,
                   sync_every: int = 64, srv_ledger: bool = False,
                   device: str | torch.device | None = None,
                   **kw) -> BroadcastSim:
    """A words-major structured BroadcastSim on one device, ledger off
    by default (its sync diff is per-round bookkeeping that timed runs
    keep out)."""
    return BroadcastSim(
        _nbrs_for(topology, n, **kw), n_values=n_values,
        sync_every=sync_every, exchange=make_exchange(topology, n, **kw),
        srv_ledger=srv_ledger,
        sync_diff=make_sync_diff(topology, n, **kw) if srv_ledger
        else None,
        device=device)


def discover_rounds(topology: str, n: int, n_values: int, **kw) -> int:
    """Host-only convergence round count of a tree flood: the max over
    injected values of the eccentricity of the value's origin (origins
    are round-robin ``v % n``).  For each ancestor a of o, the farthest
    node whose path to o turns at a is the deepest descendant of a
    outside the branch containing o; heap indexing makes subtree depth
    ranges closed-form."""
    _tree_only(topology)
    k = kw.get("branching", 4)

    def depth(i: int) -> int:
        d = 0
        while i > 0:
            i = (i - 1) // k
            d += 1
        return d

    def submax(a: int) -> int:
        # depth of the deepest descendant of node a
        lo = hi = a
        d = depth(a)
        while True:
            lo, hi = k * lo + 1, k * hi + k
            if lo > n - 1:
                return d
            hi = min(hi, n - 1)
            d += 1

    def ecc(o: int) -> int:
        best = submax(o) - depth(o)          # down o's own subtree
        child, a = o, (o - 1) // k
        while o > 0:
            da = depth(a)
            m = max((submax(c)
                     for c in range(k * a + 1, min(k * a + k, n - 1) + 1)
                     if c != child), default=da)
            best = max(best, (depth(o) - da) + (m - da))
            if a == 0:
                break
            child, a = a, (a - 1) // k
        return best

    return max(ecc(v % n) for v in range(min(n_values, n)))


def flood_msgs64(sim: BroadcastSim, state) -> int:
    """The closed-form value-message ledger of a pure flood, unwrapped:
    sum_i deg_i * (pc_i(received) - pc_i(frontier)) in int64 (the uint32
    ``state.msgs`` wraps in the many-values regime)."""
    dpc = (col_popcount(state.received)
           - col_popcount(state.frontier)).to(torch.int64)
    return int((sim.deg * dpc).sum())


class TimedRun:
    """One convergence benchmark on a CUDA sim: :meth:`prepare` stages
    and warms the loop once, :meth:`sample` times the fixed-trip loop
    alone with CUDA events (re-staging before each sample, off the
    clock), :meth:`finish` assembles the final state and verifies
    convergence."""

    def __init__(self, sim: BroadcastSim, inject: np.ndarray,
                 rounds: int) -> None:
        if sim.device.type != "cuda":
            raise ValueError("TimedRun times with CUDA events: build the "
                             f"sim on a CUDA device, not {sim.device}")
        self.sim, self.inject, self.rounds = sim, inject, rounds
        self.samples: list[float] = []

    def _run(self, state0):
        if self.parts is None:
            return self.sim.run_staged_fixed(state0, self.rounds,
                                             donate=True)
        return self.parts[0](state0.received, state0.frontier)

    def prepare(self) -> None:
        self.parts = self.sim.build_fixed(self.rounds, donate=True)
        state0, self.target = self.sim.stage(self.inject)
        self._run(state0)
        torch.cuda.synchronize(self.sim.device)

    def sample(self, repeats: int = 3) -> None:
        for _ in range(max(1, repeats)):
            state0, _ = self.sim.stage(self.inject)
            torch.cuda.synchronize(self.sim.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._run(state0)
            end.record()
            end.synchronize()
            self.samples.append(start.elapsed_time(end) / 1e3)
        self._last_s0, self._last = state0, out

    def finish(self):
        """(median seconds, rounds, final state)."""
        state = (self._last if self.parts is None
                 else self.parts[1](self._last_s0, self._last))
        if not self.sim.converged(state, self.target):
            raise RuntimeError(f"the fixed {self.rounds}-round flood did "
                               "not converge: discover_rounds is wrong")
        if state.t != self.rounds:
            raise RuntimeError(f"t = {state.t} after {self.rounds} rounds")
        return (sorted(self.samples)[len(self.samples) // 2], self.rounds,
                state)


def bench_structured(n: int, entries, repeats: int = 3,
                     device: str | torch.device | None = None) -> dict:
    """Timed tree-flood convergence runs.  ``entries``: (name, topology,
    n_values, kw, n_dirs) tuples.  Returns {name: {wall_s (the median
    sample), samples_s, rounds, ms_per_round, gbytes_per_s_lb, msgs64,
    _state}} (msgs64 for pure-flood runs only) — gbytes_per_s_lb is the
    reference's logical-traffic lower bound on the achieved memory
    rate in GB/s: what a perfectly fused round must stream (read
    received+frontier, write received+frontier, plus one full-bitset
    payload read per exchange direction), over the measured time."""
    out: dict = {}
    for name, topo, nv, kw, n_dirs in entries:
        sim = structured_sim(topo, n, nv, device=device, **kw)
        tr = TimedRun(sim, make_inject(n, nv),
                      discover_rounds(topo, n, nv, **kw))
        tr.prepare()
        tr.sample(repeats)
        dt, rounds, state = tr.finish()
        bitset_gb = n * (nv // 32) * 4 / 1e9
        entry = {
            "wall_s": dt, "samples_s": list(tr.samples), "rounds": rounds,
            "ms_per_round": dt / rounds * 1e3,
            "gbytes_per_s_lb": (4 + n_dirs) * bitset_gb * rounds / dt,
            "_state": state}
        if tr.parts is not None:     # the closed form holds for floods only
            entry["msgs64"] = flood_msgs64(sim, state)
        out[name] = entry
    return out
