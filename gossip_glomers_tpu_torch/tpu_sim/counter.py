"""The grow-only counter (Gossip Glomers challenge 4) on PyTorch: the port
of gossip_glomers_tpu/tpu_sim/counter.py's single-device ``CounterSim``.

Semantics (the reference node's counter/add.go and main.go): ``add``
acks before durability, buffering deltas in ``pending``; flushing is
read-then-CAS against ONE sequentially consistent KV key, losers retry
with a refreshed read; ``read`` serves each node's ``cached`` view of the
KV, refreshed by a periodic poll.  Two flush modes:

- **cas**: one CAS winner a round, the least seeded per-round hashed
  priority among the fresh-read contenders (``cached == kv``), the row id
  breaking ties; in the ``packed`` key layout (below 2^23 nodes) the
  priority is the hash's top ``31 - row_bits`` bits, in the ``wide`` one
  the whole hash (``winner_key="auto"`` picks wide from 24 row bits);
- **allreduce**: every reachable node's pending is applied at once.

A node reaches the KV unless a ``kv_sched`` window blocks it, or, under a
:class:`.faults.FaultPlan`, it is down or its KV exchange is lost this
round; a node restarting this round first loses ``pending`` and
``cached`` (amnesia).  ``kv_backend="device"`` keeps the key in the
device store (:mod:`.kvstore`): each round reads it from its row and
commits the round's one CAS to it, with ``kv_amnesia`` (a restarting
owner loses its row) and seq-kv stale reads (``stale_prob``).

One round is two kernels, :func:`.kernels.counter_select` (the read pass:
winner or sum, the new ``kv`` and ``msgs``, finalized on the card) and
:func:`.kernels.counter_apply` (the update pass), and no host sync; the
per-node gate byte they read (:data:`.kernels.GATE_BLOCKED` /
:data:`.kernels.GATE_WIPE`) is folded on the host's schedule from the
windows and the plan active at round ``t``.  ``t`` is a host int, ``kv``
a 0-dim int32 device tensor and ``msgs`` a 0-dim int64 holding the
reference's uint32 ledger.

The open-loop traffic driver (:meth:`CounterSim.run_traffic`, with its
telemetry ring) injects the seeded client adds of a
:class:`.traffic.TrafficSpec` before each round and tracks each op until
every node's cached read covers its flush.  The observed driver
(:meth:`CounterSim.run_observed`) records the telemetry ring and the
provenance stamps (:mod:`.provenance`: each node's flush round, the KV
value it landed in and the round every cache caught up to it) beside the
ordinary rounds.

Not ported yet, and raising: meshes and ``dcn_mode`` (ROADMAP.md Queue A
item 10); the program audit (item 14).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import faults, kernels, kvstore, provenance, telemetry, traffic
from .engine import (active_windows, collectives, fori_rounds,
                     resolve_block, resolve_device, scan_blocks)
from .kernels import GATE_BLOCKED, GATE_WIPE

# the reference's methods that this port leaves out, by ROADMAP.md Queue
# A item
_UNPORTED_METHODS = {"audit_run_program": 14, "audit_traffic_program": 14,
                     "audit_observed_program": 14}


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md Queue A item {item})")


@dataclasses.dataclass(frozen=True)
class KVReach:
    """Which nodes can reach the KV service: window w is active for rounds
    [starts[w], ends[w]); while active, the nodes with ``blocked[w, i]``
    can neither flush nor poll.  Bounds are host ints, ``blocked`` a (P,
    N) bool tensor."""

    starts: tuple[int, ...]
    ends: tuple[int, ...]
    blocked: torch.Tensor

    @staticmethod
    def none(n_nodes: int, device: str | torch.device = "cpu") -> "KVReach":
        return KVReach((), (), torch.zeros((0, n_nodes), dtype=torch.bool,
                                           device=device))

    @staticmethod
    def from_numpy(starts: Sequence[int], ends: Sequence[int],
                   blocked: np.ndarray,
                   device: str | torch.device = "cpu") -> "KVReach":
        blocked = np.asarray(blocked, bool)
        starts = tuple(int(v) for v in np.asarray(starts).reshape(-1))
        ends = tuple(int(v) for v in np.asarray(ends).reshape(-1))
        if blocked.ndim != 2 or not len(starts) == len(ends) \
                == blocked.shape[0]:
            raise ValueError(
                f"KVReach needs starts (P,), ends (P,), blocked (P, N); "
                f"got {len(starts)}, {len(ends)} and {blocked.shape}")
        return KVReach(starts, ends,
                       torch.from_numpy(blocked.copy()).to(device))

    def to(self, device: str | torch.device) -> "KVReach":
        return dataclasses.replace(self, blocked=self.blocked.to(device))


class CounterState(NamedTuple):
    pending: torch.Tensor   # (N,) int32 — acked, unflushed deltas
    cached: torch.Tensor    # (N,) int32 — each node's last-read KV value
    kv: torch.Tensor        # () int32 — the seq-kv key's value
    t: int                  # round counter
    msgs: torch.Tensor      # () int64 — KV messages, a uint32 ledger
    # kv_backend="device": the store's rows, ``kv`` their one key's view
    rows: kvstore.KVRows | None = None


def _reach(t: int, row_ids: torch.Tensor, sched: KVReach) -> torch.Tensor:
    """(rows,) bool — who can reach the KV at round ``t``: the windows
    active at ``t`` (:func:`.engine.active_windows`) folded on the
    host's schedule."""
    ok = torch.ones(row_ids.shape, dtype=torch.bool, device=row_ids.device)
    for w in active_windows(sched.starts, sched.ends, t):
        ok = ok & ~sched.blocked[w][row_ids.to(torch.int64)]
    return ok


class CounterSim:
    """Round-synchronous g-counter simulator.  Drive with :meth:`add` and
    :meth:`step` / :meth:`run`; read with :meth:`reads` (each node's
    cached value, not the KV)."""

    def __init__(self, n_nodes: int, *, mode: str = "cas",
                 poll_every: int = 4, kv_sched: KVReach | None = None,
                 mesh=None, seed: int = 0, winner_key: str = "auto",
                 fault_plan: faults.FaultPlan | None = None,
                 union_block: int | str | None = None,
                 kv_backend: str = "host", kv_amnesia: bool = False,
                 stale_prob: float = 0.0, stale_until: int = 0,
                 stale_seed: int | None = None, dcn_mode=None,
                 device: str | torch.device | None = None) -> None:
        """The reference's arguments (its docstring has them in full):
        ``fault_plan`` the crash/loss nemesis (its dup stream has no
        effect on a read/CAS protocol); ``union_block`` the slab size of
        the allreduce fault gate's sweep (:func:`.engine.scan_blocks`,
        the same result at any size); ``kv_backend="device"`` the key in
        the :mod:`.kvstore` rows, with ``kv_amnesia`` and the
        ``stale_*`` coins (cas mode; a dup stream is refused).
        ``device``: where the state lives (default CUDA; raises if there
        is none).  ``mesh`` and ``dcn_mode`` raise (ROADMAP.md Queue A
        item 10)."""
        if mesh is not None:
            raise _unported("CounterSim(mesh=...)", 10)
        if dcn_mode is not None:
            raise _unported("CounterSim(dcn_mode=...)", 10)
        if mode not in ("cas", "allreduce"):
            raise ValueError(f"unknown mode {mode!r}")
        if winner_key not in ("auto", "packed", "wide"):
            raise ValueError(f"unknown winner_key {winner_key!r}")
        if kv_backend not in ("host", "device"):
            raise ValueError(f"unknown kv_backend {kv_backend!r}")
        if kv_backend != "device" and (kv_amnesia or stale_prob):
            raise ValueError(
                "kv_amnesia/stale_prob need kv_backend='device' "
                "(host-backend staleness lives in harness KVService)")
        if stale_prob and mode != "cas":
            raise ValueError("stale_prob models the cas read-retry "
                             "loop; allreduce has no read path")
        if kv_backend == "device":
            kvstore.reject_dup_stream(fault_plan, "CounterSim")
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self.mode = mode
        self.poll_every = poll_every
        self.seed = seed
        self.kv_backend = kv_backend
        self.kv_amnesia = bool(kv_amnesia)
        self._device_kv = kv_backend == "device"
        if self._device_kv:
            # one seq-kv key, routed by the store's stateless hash
            self._kv_layout = kvstore.make_layout(1, n_nodes, seed=seed)
            self._slots = kvstore.key_slots(self._kv_layout, self.device)
            self._key_at = (int(self._kv_layout.owner[0]),
                            int(self._kv_layout.slot[0]))
        self._stale_num = (kvstore.stale_num_of(stale_prob)
                           if stale_prob else 0)
        self._stale_until = int(stale_until)
        self._stale_seed = seed if stale_seed is None else stale_seed
        self._row_bits = max(1, (n_nodes - 1).bit_length())
        if mode == "cas" and n_nodes >= 2**31:
            raise ValueError("cas winner keys support n_nodes < 2^31")
        if winner_key == "packed" and self._row_bits >= 24:
            raise ValueError(
                "packed cas winner keys need n_nodes <= 2^23 (24+ row "
                "bits leave too few priority bits for a randomized "
                "winner); use winner_key='wide' or 'auto'")
        self._wide = (winner_key == "wide"
                      or (winner_key == "auto" and self._row_bits >= 24))
        self.kv_sched = (KVReach.none(n_nodes, self.device) if kv_sched is None
                         else kv_sched.to(self.device))
        if self.kv_sched.blocked.shape[1:] != (n_nodes,):
            raise ValueError(f"KVReach blocked "
                             f"{tuple(self.kv_sched.blocked.shape)} is not "
                             f"(P, {n_nodes})")
        # each window's gate bytes, made once
        self._win_gates = [w.to(torch.uint8) * GATE_BLOCKED
                           for w in self.kv_sched.blocked]
        if fault_plan is not None and fault_plan.n_nodes != n_nodes:
            raise ValueError(
                f"FaultPlan is for {fault_plan.n_nodes} nodes, sim has "
                f"{n_nodes}")
        self.fault_plan = (None if fault_plan is None
                           else fault_plan.to(self.device))
        # two coin/mask evaluations per node row
        self._ub = resolve_block(max(1, n_nodes), union_block,
                                 per_row_bytes=8)
        # the plan's coins and masks take the node ids
        self._row_ids = (None if fault_plan is None else
                         collectives(n_nodes, device=self.device).row_ids)
        self._work = kernels.counter_work(self.device)
        self._rows = torch.arange(n_nodes, dtype=torch.int32,
                                  device=self.device)
        self._traffic = {}

    def __getattr__(self, name: str):
        if name in _UNPORTED_METHODS:
            raise _unported(f"CounterSim.{name}", _UNPORTED_METHODS[name])
        raise AttributeError(name)

    def init_state(self) -> CounterState:
        def z(shape=(self.n_nodes,)):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        rows = (kvstore.init_rows(self._kv_layout, self.device)
                if self._device_kv else None)
        return CounterState(pending=z(), cached=z(), kv=z(()), t=0,
                            msgs=torch.zeros((), dtype=torch.int64,
                                             device=self.device),
                            rows=rows)

    # -- op injection ----------------------------------------------------

    def add(self, state: CounterState, deltas) -> CounterState:
        """Buffer acked deltas: ``deltas`` is (N,) per-node int32 (the
        batched ``add`` handler — the ack precedes durability)."""
        d = torch.as_tensor(np.asarray(deltas, np.int32)).to(self.device)
        return state._replace(pending=state.pending + d)

    # -- round -----------------------------------------------------------

    def _gate(self, t: int) -> tuple[torch.Tensor | None,
                                     torch.Tensor | None]:
        """(gate bytes or None, amnesia rows or None) of round ``t``: the
        KV windows active at ``t`` and, under a plan, its amnesia rows,
        down nodes and lost KV exchanges."""
        act = active_windows(self.kv_sched.starts, self.kv_sched.ends, t)
        gate = None
        for w in act:
            gate = self._win_gates[w] if gate is None \
                else gate | self._win_gates[w]
        plan = self.fault_plan
        if plan is None:
            return gate, None
        row_ids = self._row_ids
        wipe = faults.amnesia(plan, t, row_ids)
        if self._ub is not None and self.mode == "allreduce":
            # the fault gate slab by slab (stateless coins: the same
            # result at any block size)
            ub = self._ub

            def gate_blk(carry, lo):
                ids = row_ids[lo:lo + ub]
                carry[lo:lo + ub] = (faults.node_up(plan, t, ids)
                                     & ~faults.kv_drop(plan, t, ids))
                return carry

            ok = scan_blocks(gate_blk, torch.zeros(
                self.n_nodes, dtype=torch.bool, device=self.device),
                self.n_nodes, ub)
        else:
            ok = faults.node_up(plan, t, row_ids) \
                & ~faults.kv_drop(plan, t, row_ids)
        bits = (~ok).to(torch.uint8) * GATE_BLOCKED \
            + wipe.to(torch.uint8) * GATE_WIPE
        return (bits if gate is None else bits | gate), wipe

    def _round(self, state: CounterState, out=None) -> CounterState:
        """One round: the amnesia rows wiped, the flushes (one CAS winner,
        or every reachable node's pending), the cache refresh of the
        contenders, the winner and the polled nodes.  ``out``: the
        (pending, cached) buffers to write (:meth:`run_fused`'s inputs,
        whose KV rows the CAS then updates in place too); new tensors
        when None."""
        t = state.t
        gate, wipe = self._gate(t)
        rows = state.rows
        if self._device_kv:
            if wipe is not None and self.kv_amnesia:
                # the KV rows are node state: a restarting owner loses
                # its register through the same amnesia coin
                rows = kvstore.wipe_rows(rows, wipe)
            # the authoritative value is read from the store
            kv0 = rows.vals[self._key_at]
        else:
            kv0 = state.kv
        cas = self.mode == "cas"
        poll = self.poll_every > 0 and t % self.poll_every == 0
        kv, msgs = kernels.counter_select(
            state.pending, state.cached, gate, kv0, state.msgs, self._work,
            cas=cas, wide=self._wide, row_bits=self._row_bits, t=t,
            seed=self.seed, poll=poll)
        stale_num = self._stale_num if t < self._stale_until else 0
        pending, cached = kernels.counter_apply(
            state.pending, state.cached, gate, kv, self._work, cas=cas,
            poll=poll, stale_num=stale_num, stale_seed=self._stale_seed,
            t=t, out=out)
        if self._device_kv:
            # commit the round's one linearization step: a CAS from the
            # value read, so the store and ``kv`` never diverge
            rows = kvstore.cas_apply_at(rows, self._slots,
                                        (kv != kv0).reshape(1),
                                        kv0.reshape(1), kv.reshape(1),
                                        donate=out is not None)
        return CounterState(pending=pending, cached=cached, kv=kv, t=t + 1,
                            msgs=msgs, rows=rows)

    def step(self, state: CounterState) -> CounterState:
        return self._round(state)

    def run(self, state: CounterState, n_rounds: int) -> CounterState:
        return fori_rounds(self._round, state, n_rounds)

    def run_fused(self, state: CounterState,
                  n_rounds: int) -> CounterState:
        """:meth:`run` with the input state's ``pending``, ``cached`` and
        KV rows donated: every round updates them in place, so the loop
        holds one copy of the node rows.  The state passed in must not be
        used again."""
        out = (state.pending, state.cached)
        return fori_rounds(lambda s: self._round(s, out=out), state,
                           n_rounds)

    # -- open-loop traffic -----------------------------------------------

    def _traffic_index(self, tspec) -> dict:
        """The traffic driver's per-spec index tensors
        (:func:`.traffic.client_index` and every row id), cached by the
        spec's static key."""
        key = tspec.program_key
        if key not in self._traffic:
            ix = traffic.client_index(tspec, self.n_nodes, self.device)
            ix["rows"] = self._rows
            self._traffic[key] = ix
        return self._traffic[key]

    def _traffic_round(self, state: CounterState, ts, tspec, tplan,
                       ix: dict, tel=None, tel_mask=None):
        """One traffic-injected round (the reference's): classify this
        round's arrivals (home node down, the ``intake`` cap, op slots
        exhausted: deferred), add each accepted op's delta 1 to its home
        node's ``pending`` (the ack precedes durability), run the round,
        then advance the tracker:

        - a node whose pending drained this round flushes its clients'
          open ops, each recording ``op_aux = kv`` after the round; ops
          whose delta dies in this round's amnesia wipe are marked
          ``op_aux = -2`` first, so no later flush can claim them (they
          stay in flight: lost acknowledged writes);
        - an op completes once every node's cached read covers its flush
          value (``min(cached) >= op_aux``)."""
        t, node = state.t, ix["node"]
        plan = self.fault_plan
        arr = traffic.arrive(tplan, t, ix["ids"])
        rows = ix["rows"]
        up_t = faults.node_up(plan, t, rows) if plan is not None else None
        accept = (faults.node_up(plan, t, node) if plan is not None
                  else torch.ones_like(arr))
        if tspec.intake is not None:
            accept = accept & (
                traffic.intake_rank(arr, tspec.clients_per_node)
                < tspec.intake)
        ts, ok, _k = traffic.issue(ts, arr, accept, t)
        add = torch.zeros(self.n_nodes, dtype=torch.int32,
                          device=self.device).index_add_(
            0, node, ok.to(torch.int32))
        state = state._replace(pending=state.pending + add)
        open_ops = (ts.issue_round >= 0) & (ts.done_round < 0)
        op_aux = ts.op_aux
        if plan is not None:
            wiped = faults.amnesia(plan, t, rows)[node]
            op_aux = torch.where(open_ops & (op_aux == -1) & wiped[:, None],
                                 -2, op_aux)
        gate = None if tel is None else self._flush_gate(state)
        s2 = self._round(state)
        flushed = (state.pending > 0) & (s2.pending == 0)
        if up_t is not None:
            flushed = flushed & up_t
        aux = torch.where(open_ops & (op_aux == -1) & flushed[node][:, None],
                          s2.kv, op_aux)
        ts = ts._replace(op_aux=aux)
        min_cached = s2.cached.min()

        def bit_fn(lo, block):
            a = aux[lo:lo + block]
            return (a >= 0) & (min_cached >= a)

        ts = traffic.done_scan(ts, bit_fn, s2.t, ix["block"])
        if tel is None:
            return s2, ts, None
        vals = (self._tel_series(gate, s2, tel_mask)
                + traffic.tel_series(ts))
        return s2, ts, telemetry.record(tel, t, vals, tel_mask)

    def _flush_gate(self, s0: CounterState) -> tuple:
        """``(live, want)`` of the round about to run on ``s0``,
        recomputed from the same reach, liveness and coins the round uses
        (stateless, so they cannot drift from it): ``live`` the nodes up
        (None without a plan), ``want`` the nodes that try to flush (a
        positive pending after the amnesia wipe, and KV reach).  Taken
        before the round, which may update ``pending`` in place."""
        plan, rows = self.fault_plan, self._rows
        reach = _reach(s0.t, rows, self.kv_sched)
        pend0 = s0.pending
        live = None
        if plan is not None:
            live = faults.node_up(plan, s0.t, rows)
            pend0 = torch.where(faults.amnesia(plan, s0.t, rows), 0, pend0)
            reach = reach & live & ~faults.kv_drop(plan, s0.t, rows)
        return live, (pend0 > 0) & reach

    def _tel_series(self, gate: tuple, s1: CounterState, mask) -> tuple:
        """One round's telemetry row (``telemetry.SIM_SERIES['counter']``)
        from the round's :meth:`_flush_gate` and output state: the flush
        attempts, the acks among them, the pending and KV totals."""
        live, want = gate
        acks = want & (s1.pending == 0)
        n_want, n_acks = want.sum(dtype=torch.int64), acks.sum(
            dtype=torch.int64)
        return (self.n_nodes if live is None else live.sum(dtype=torch.int64),
                s1.pending.sum(dtype=torch.int64), n_want, n_acks,
                n_want - n_acks, s1.kv, s1.msgs)

    def telemetry_state(self, tel_spec) -> "telemetry.TelemetryState":
        return telemetry.init_state(tel_spec, device=self.device)

    # -- observed runs: the telemetry ring and the provenance record -------

    def provenance_state(self, pspec) -> "provenance.CounterProv":
        return provenance.init_counter(self.n_nodes, device=self.device)

    def _prov_record(self, gate: tuple, s2: CounterState, prov):
        """One round's provenance stamps (the reference's), first
        occurrence only: ``flush_round`` / ``flush_kv`` where a node's
        positive pending first drained through a reachable flush (an
        amnesia wipe is no flush: the wiping node is down), the round
        after and the KV value it landed in; ``visible_round`` once every
        cache has caught up to that value (``min(cached) >= flush_kv``)."""
        flushed = gate[1] & (s2.pending == 0)
        newf = flushed & (prov.flush_round < 0)
        fr = torch.where(newf, s2.t, prov.flush_round)
        fk = torch.where(newf, s2.kv, prov.flush_kv)
        vr = provenance.stamp(prov.visible_round,
                              (fr >= 0) & (s2.cached.min() >= fk), s2.t)
        return provenance.CounterProv(flush_round=fr, flush_kv=fk,
                                      visible_round=vr)

    def run_observed(self, state: CounterState, tel, tspec, n_rounds: int,
                     *, donate: bool = False, prov=None, prov_spec=None):
        """:meth:`run` with the per-round telemetry ring (``tel`` /
        ``tspec``, a ``TelemetrySpec(traffic=False)``) and / or the
        per-node flush / KV / visibility stamps (``prov`` /
        ``prov_spec``) recorded beside the state, which they only read:
        the state equals the plain drivers' bit for bit.  With ``donate``
        the rounds update the state's ``pending``, ``cached`` and KV rows
        in place (:meth:`run_fused`) and the ring too; else the state and
        ring are left as they were.  Returns ``(state, tel?, prov?)``."""
        if (tel is None) != (tspec is None):
            raise ValueError(
                "pass tel and tel_spec together (build the ring with "
                "telemetry.init_state(spec))")
        provenance.prov_key(prov, prov_spec, "counter")
        if tspec is None and prov_spec is None:
            raise ValueError(
                "observed drivers need a TelemetrySpec and/or a "
                "ProvenanceSpec")
        if tspec is not None and (tspec.workload != "counter"
                                  or tspec.traffic):
            raise ValueError(
                "run_observed needs a TelemetrySpec(workload="
                "'counter', traffic=False); open-loop runs record "
                "through run_traffic(tel=...)")
        out = (state.pending, state.cached) if donate else None
        if not donate:
            tel = None if tel is None else tel.clone()
        mask = None if tel is None else tspec.static_mask
        for _ in range(n_rounds):
            gate = self._flush_gate(state)
            t = state.t
            state = self._round(state, out=out)
            if tel is not None:
                tel = telemetry.record(tel, t,
                                       self._tel_series(gate, state, mask),
                                       mask)
            if prov is not None:
                prov = self._prov_record(gate, state, prov)
        return ((state,) + (() if tel is None else (tel,))
                + (() if prov is None else (prov,)))

    def traffic_state(self, tspec) -> "traffic.TrafficState":
        return traffic.init_state(tspec, device=self.device)

    def run_traffic(self, state: CounterState, ts, tspec, n_rounds: int, *,
                    donate: bool = False, tel=None, tel_spec=None):
        """Open-loop serving driver: ``n_rounds`` rounds, each injecting
        the spec's seeded arrivals before the ordinary flush / poll round
        and advancing the per-op latency tracker after it.  The rounds
        make new node rows, so the state passed in is never changed;
        with ``donate`` the tracker and the ring are updated in place,
        else copied first.  ``tel`` / ``tel_spec``: record the telemetry
        ring too, and return ``(state, ts, tel)``."""
        telemetry.tel_key(tel, tel_spec, "counter")
        ix = self._traffic_index(tspec)
        tplan = tspec.compile()
        if not donate:
            ts = ts.clone()
            tel = None if tel is None else tel.clone()
        mask = None if tel is None else tel_spec.static_mask
        for _ in range(n_rounds):
            state, ts, tel = self._traffic_round(state, ts, tspec, tplan,
                                                 ix, tel, mask)
        return (state, ts) if tel is None else (state, ts, tel)

    # -- reads -----------------------------------------------------------

    def reads(self, state: CounterState) -> np.ndarray:
        """(N,) int32 — each node's ``read`` reply (its cached value)."""
        return state.cached.cpu().numpy()

    def kv_value(self, state: CounterState) -> int:
        return int(state.kv)


def _build_batch_round(sim: CounterSim):
    """One scenario's round for the scenario batches (:mod:`.scenario`),
    which run each counter scenario on its own sim under its own plan:
    ``rnd(state, tel=None, tel_spec=None) -> (state, tel)`` steps once in
    place (:meth:`CounterSim.run_fused`), recording the telemetry row
    when given a ring (:meth:`CounterSim.run_observed`)."""
    def rnd(state: CounterState, tel=None, tel_spec=None):
        if tel is None:
            return sim.run_fused(state, 1), None
        return sim.run_observed(state, tel, tel_spec, 1, donate=True)
    return rnd


def _batch_converged(state: CounterState, member=None) -> torch.Tensor:
    """() bool on the device: pending drained and every cached read equal
    to the KV, on the ``member`` rows ((N,) bool) when given; pending is
    summed over every row."""
    cached_ok = state.cached == state.kv
    if member is not None:
        cached_ok = cached_ok | ~member
    return (state.pending.sum() == 0) & cached_ok.all()
