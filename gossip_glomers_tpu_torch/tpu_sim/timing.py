"""Benchmark timing for broadcast convergence runs on a CUDA device.

The port of gossip_glomers_tpu/tpu_sim/timing.py: run exactly the
convergence round count (host-computed, :func:`discover_rounds`) as the
fixed-trip runner — for a words-major structured flood,
``BroadcastSim.build_fixed``'s flood specialization (the fused flood-round
kernel loop, whose ledger is recovered in closed form after the loop);
for a node-major gather sim, the generic round loop — and time it alone
with CUDA events.  Staging stays off the clock; each sample re-stages,
because the flood loop updates ``received`` in place.

On a mesh (:func:`..parallel.mesh.pick_mesh`, one rank a block of the
node axis) the sim takes the halo exchanges and every rank times its own
run of the same rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.topology import (circulant, expander_strides, grid,
                                 grid_cols, line, ring, to_padded_neighbors,
                                 tree)
from .broadcast import BroadcastSim, make_inject
from .engine import node_shards
from .kernels import col_popcount
from .structured import (make_exchange, make_faulted,
                         make_sharded_exchange, make_sharded_sync_diff,
                         make_sync_diff)


def _nbrs_for(topology: str, n: int, **kw) -> np.ndarray:
    if topology == "tree":
        return to_padded_neighbors(tree(n, branching=kw.get("branching", 4)))
    if topology == "circulant":
        return circulant(n, list(kw["strides"]))
    if topology == "grid":
        # cols threads through so adjacency, exchange, and
        # discover_rounds can never disagree on the grid shape
        return to_padded_neighbors(grid(n, kw.get("cols")))
    if topology in ("ring", "line"):
        builder = {"ring": ring, "line": line}[topology]
        return to_padded_neighbors(builder(n))
    raise ValueError(topology)


def structured_sim(topology: str, n: int, n_values: int, *,
                   sync_every: int = 64, srv_ledger: bool = False,
                   parts=None, device: str | torch.device | None = None,
                   mesh="auto", **kw) -> BroadcastSim:
    """A words-major structured BroadcastSim, ledger off by default (its
    sync diff is per-round bookkeeping that timed runs keep out), on
    ``mesh`` with the halo exchanges: by default
    :func:`..parallel.mesh.pick_mesh` (None, one device, in a world of
    one process), None for one device.  ``parts`` (a
    :class:`.broadcast.Partitions`, windows in rounds) runs its schedule
    on the structured path through the masked closures of
    :func:`.structured.make_faulted`."""
    if isinstance(mesh, str) and mesh == "auto":
        from ..parallel.mesh import pick_mesh

        mesh = pick_mesh(device=device)
    shards = None if mesh is None else node_shards(mesh)
    sharded = sharded_diff = None
    if mesh is not None:
        sharded = make_sharded_exchange(topology, n, shards, **kw)
        sharded_diff = make_sharded_sync_diff(topology, n, shards, **kw)
    faulted = None
    if parts is not None and parts.n_windows:
        faulted = make_faulted(topology, n, parts.group.cpu().numpy(),
                               n_shards=shards, **kw)
    return BroadcastSim(
        _nbrs_for(topology, n, **kw), n_values=n_values,
        sync_every=sync_every, parts=parts,
        exchange=make_exchange(topology, n, **kw),
        srv_ledger=srv_ledger,
        sync_diff=make_sync_diff(topology, n, **kw) if srv_ledger
        else None,
        faulted=faulted, device=device if mesh is None else None,
        mesh=mesh, sharded_exchange=sharded,
        sharded_sync_diff=sharded_diff if srv_ledger else None)


def discover_rounds(topology: str, n: int, n_values: int, **kw) -> int:
    """Host-only convergence round count for a structured flood: the max
    over injected values of the eccentricity of the value's origin
    (origins are round-robin ``v % n``):

    - tree: exact ecc(o) — for each ancestor a of o, the farthest node
      whose path to o turns at a is the deepest descendant of a outside
      the branch containing o (heap indexing makes subtree depth ranges
      closed-form);
    - circulant / ring: vertex-transitive, so ecc is the same for every
      origin — one numpy BFS over the stride graph gives it;
    - line: ecc(o) = max(o, n-1-o);
    - grid (ragged, grid_cols columns): Manhattan ecc over the corner
      candidates of the staircase-convex cell region."""
    if topology == "tree":
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
    if topology in ("circulant", "ring"):
        strides = [1] if topology == "ring" else list(kw["strides"])
        reach = np.zeros(n, bool)
        reach[0] = True
        frontier = reach.copy()
        rounds = 0
        while not reach.all():
            new = np.zeros(n, bool)
            for s in strides:
                new |= np.roll(frontier, s) | np.roll(frontier, -s)
            frontier = new & ~reach
            if not frontier.any():
                raise ValueError("circulant strides do not connect")
            reach |= frontier
            rounds += 1
        return rounds
    if topology == "line":
        return max(max(v % n, n - 1 - v % n)
                   for v in range(min(n_values, n)))
    if topology == "grid":
        cols = kw.get("cols") or grid_cols(n)
        rows = (n + cols - 1) // cols
        last = n - (rows - 1) * cols       # width of the ragged last row

        def ecc(o: int) -> int:
            r0, c0 = divmod(o, cols)
            best = 0
            for r in (0, rows - 1):
                w = cols if r < rows - 1 else last
                for c in (0, w - 1):
                    best = max(best, abs(r - r0) + abs(c - c0))
            # the ragged corner (cols-1 of the second-to-last row) can
            # exceed all four outer corners when the last row is short
            if last < cols and rows >= 2:
                best = max(best, abs(rows - 2 - r0) + abs(cols - 1 - c0))
            return best

        return max(ecc(v % n) for v in range(min(n_values, n)))
    raise ValueError(topology)


def flood_msgs64(sim: BroadcastSim, state) -> int:
    """The closed-form value-message ledger of a words-major pure flood,
    unwrapped: sum_i deg_i * (pc_i(received) - pc_i(frontier)) in int64
    (the uint32 ``state.msgs`` wraps in the many-values regime)."""
    if not sim.words_major:
        raise ValueError("flood_msgs64 is the words-major pure-flood "
                         "closed form")
    dpc = (col_popcount(state.received)
           - col_popcount(state.frontier)).to(torch.int64)
    return int(sim._psum((sim.deg * dpc).sum()))


class TimedRun:
    """One convergence benchmark on a CUDA sim: :meth:`prepare` stages
    and warms the loop once, :meth:`sample` times the fixed-trip runner
    alone with CUDA events (re-staging before each sample, off the
    clock), :meth:`finish` assembles the final state and verifies
    convergence.  A words-major flood times its kernel loop alone; any
    other sim (a gather sim, or one whose ledger needs per-round
    bookkeeping) times its generic round loop."""

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
                     device: str | torch.device | None = None,
                     mesh="auto") -> dict:
    """Timed structured-flood convergence runs.  ``entries``: (name,
    topology, n_values, kw, n_dirs) tuples.  Returns {name: {wall_s (the
    median sample), samples_s, rounds, ms_per_round, gbytes_per_s_lb,
    msgs64, _state}} (msgs64 for pure-flood runs only) — gbytes_per_s_lb
    is the reference's logical-traffic lower bound on the achieved
    memory rate in GB/s: what a perfectly fused round must stream (read
    received+frontier, write received+frontier, plus one full-bitset
    payload read per exchange direction), over the measured time.
    ``mesh``: as :func:`structured_sim`'s (each rank times its own
    samples)."""
    out: dict = {}
    for name, topo, nv, kw, n_dirs in entries:
        sim = structured_sim(topo, n, nv, device=device, mesh=mesh, **kw)
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


def words_axis_entries(n: int, n_values: int, *, branching: int = 4,
                       strides_seed: int = 0) -> list:
    """The (name, topology, n_values, kw, n_dirs) entries of the
    many-values regime: the tree and the degree-8 circulant expander."""
    strides = expander_strides(n, degree=8, seed=strides_seed)
    return [("tree", "tree", n_values, {"branching": branching},
             branching + 1),
            ("circulant", "circulant", n_values, {"strides": strides},
             2 * len(strides))]


def format_words_regime(res: dict, n_values: int) -> dict:
    """Public w128-style dict from a :func:`bench_structured` result
    holding the :func:`words_axis_entries` names."""
    out = {"n_values": n_values}
    for name in ("tree", "circulant"):
        out[name] = {k: v for k, v in res[name].items()
                     if not k.startswith("_")}
    return out
