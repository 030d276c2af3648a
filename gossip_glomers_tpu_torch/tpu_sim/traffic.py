"""Open-loop client traffic on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/traffic.py — seeded arrival schedules over a
client axis, per-op latency tracking and loud backpressure accounting
(Maelstrom's rate-based workload generator, vectorized).

- :class:`TrafficSpec`: the host-side seeded, JSON-able spec over a
  client axis — Poisson (Bernoulli a round), constant rate (a per-client
  fixed-point phase accumulator) or burst (rate-multiplier windows) —
  compiled to a :class:`TrafficPlan` of host ints, as a
  :class:`.faults.FaultPlan` keeps its schedule.
- arrival coins: stateless hashes of ``(seed, round, client)``
  (:func:`arrive`), bit-identical to the reference's and to the numpy
  twin :func:`host_arrivals`.
- :class:`TrafficState`: one entry per op slot (client, k); ``issue_round``
  is recorded at injection and ``done_round`` at the first round the op
  is globally visible.  Latency = done - issue, in rounds.

Backpressure is loud: every arrival is *issued* or *deferred* (home node
down, per-node intake saturated, op slots exhausted, or a failed Kafka
allocation), and ``arrived == issued + deferred`` holds at every round.
An op that can never complete (a counter delta that died in an amnesia
row) stays in flight and surfaces as a lost acknowledged write in the
serving runner (:mod:`..harness.serving`).

The sims' injection hooks and ``run_traffic`` drivers live with the sims
(broadcast, counter, kafka); this module owns the spec, the coins and the
tracker.  ``t`` is a host int; the tracker's counters are () int64
tensors holding uint32 values (masked to 32 bits, so they wrap where the
reference's do); :func:`resizing_defer` is the resize's intake gate.  Not
ported yet, and raising: shard specs and meshes (ROADMAP.md Queue A item
10).
:func:`batch_tplans` stacks a serving batch's plans (the scenario
batches, :mod:`.scenario`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import faults
from .engine import _env_int, resolve_device, windows_fold
from .faults import MASK32

# distinct stream salts off the shared (seed, t, id) counter family
_SALT_ARRIVE = 0x1B873593
_SALT_PHASE = 0xCC9E2D51
# Kafka's per-op key draws from this stream (a key is a pure function of
# (seed, client, slot), recomputable at completion time)
SALT_KEY = 0xA2C2A35D
_K_ID, _K_PHASE, _K_T = 0xC2B2AE35, 0x27D4EB2F, 0x9E3779B9


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md Queue A item {item})")


class TrafficPlan(NamedTuple):
    """The compiled form of a :class:`TrafficSpec`: the reference's seven
    leaves, every one a host int (the burst windows int tuples), since
    ``t`` is a host int and the arrival threshold of a round is host
    control flow."""

    kind: int                   # 0 poisson, 1 constant
    rate_num: int               # uint32: arrive iff hash < rate_num
    until: int                  # arrivals for rounds [0, until)
    b_starts: tuple[int, ...]   # burst window start (incl)
    b_ends: tuple[int, ...]     # burst window end (excl)
    b_num: tuple[int, ...]      # uint32 in-window thresholds
    seed: int                   # uint32: the replay key


def plan_specs():
    """The reference's shard specs of a plan: ROADMAP.md Queue A item
    10."""
    raise _unported("traffic.plan_specs", 10)


_KINDS = ("poisson", "constant")


@dataclass(frozen=True)
class TrafficSpec:
    """Host-side seeded open-loop traffic spec (the reference's, with its
    validation messages): ``n_clients`` clients each issue at most one op
    a round, ``rate`` the mean arrivals a client a round; clients map to
    home nodes in contiguous blocks (``n_clients >= n_nodes``) or every
    ``n_nodes / n_clients``-th node.  ``ops_per_client`` bounds each
    client's op slots, ``intake`` caps the arrivals one node accepts a
    round, ``burst`` windows ``(start, end, mult)`` multiply the Poisson
    rate inside ``[start, end)``."""

    n_nodes: int
    n_clients: int
    ops_per_client: int
    until: int
    rate: float = 0.25
    kind: str = "poisson"
    burst: tuple = field(default_factory=tuple)   # ((start, end, mult),)
    intake: int | None = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_nodes < 1 or self.n_clients < 1:
            raise ValueError("need n_nodes >= 1 and n_clients >= 1")
        if not (self.n_clients % self.n_nodes == 0
                or self.n_nodes % self.n_clients == 0):
            raise ValueError(
                f"n_clients={self.n_clients} must divide or be "
                f"divisible by n_nodes={self.n_nodes} (the static "
                "client -> home-node map keeps injection shard-local)")
        if self.ops_per_client < 1:
            raise ValueError("ops_per_client must be >= 1")
        if self.n_clients * self.ops_per_client >= 2 ** 31:
            raise ValueError(
                "n_clients * ops_per_client must fit int32 op ids")
        if self.until < 1:
            raise ValueError("until must be >= 1 round")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"rate={self.rate} must be in (0, 1] — each client "
                "issues at most one op per round")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; "
                             f"one of {_KINDS}")
        norm = []
        for start, end, mult in self.burst:
            if not 0 <= int(start) < int(end) <= self.until:
                raise ValueError(
                    f"bad burst window [{start}, {end}): windows "
                    f"must lie inside the arrival horizon "
                    f"[0, {self.until})")
            if not 0.0 < float(mult) * self.rate <= 1.0:
                raise ValueError(
                    f"burst mult {mult} pushes the in-window rate "
                    f"past 1 op/client/round (rate={self.rate})")
            norm.append((int(start), int(end), float(mult)))
        for (s1, e1, _m1), (s2, e2, _m2) in zip(
                sorted(norm), sorted(norm)[1:]):
            if s2 < e1:
                raise ValueError(
                    f"burst windows [{s1}, {e1}) and [{s2}, {e2}) "
                    "overlap — the offered-load accounting (and the "
                    "last-window-wins device fold) need disjoint "
                    "windows")
        object.__setattr__(self, "burst", tuple(norm))
        if self.intake is not None and self.intake < 0:
            raise ValueError("intake must be >= 0 (or None)")

    @property
    def clients_per_node(self) -> int:
        return max(1, self.n_clients // self.n_nodes)

    @property
    def node_stride(self) -> int:
        return max(1, self.n_nodes // self.n_clients)

    def compile(self) -> TrafficPlan:
        return TrafficPlan(
            kind=_KINDS.index(self.kind),
            rate_num=faults._rate_to_num(self.rate),
            until=self.until,
            b_starts=tuple(s for s, _e, _m in self.burst),
            b_ends=tuple(e for _s, e, _m in self.burst),
            b_num=tuple(faults._rate_to_num(min(1.0, self.rate * m))
                        for _s, _e, m in self.burst),
            seed=self.seed & MASK32)

    def to_meta(self) -> dict:
        return {"n_nodes": self.n_nodes, "n_clients": self.n_clients,
                "ops_per_client": self.ops_per_client,
                "until": self.until, "rate": self.rate,
                "kind": self.kind,
                "burst": [list(w) for w in self.burst],
                "intake": self.intake, "seed": self.seed}

    @staticmethod
    def from_meta(meta: dict) -> "TrafficSpec":
        return TrafficSpec(
            n_nodes=int(meta["n_nodes"]),
            n_clients=int(meta["n_clients"]),
            ops_per_client=int(meta["ops_per_client"]),
            until=int(meta["until"]), rate=float(meta["rate"]),
            kind=str(meta.get("kind", "poisson")),
            burst=tuple(tuple(w) for w in meta.get("burst", ())),
            intake=meta.get("intake"), seed=int(meta.get("seed", 0)))

    def with_rate(self, rate: float) -> "TrafficSpec":
        """The serving-curve sweep knob: same spec, new offered load."""
        return replace(self, rate=rate)

    @property
    def program_key(self) -> tuple:
        """The static part of the spec (the drivers cache their per-spec
        index tensors by it): rate, seed, kind, horizon and the burst
        values ride the plan."""
        return (self.n_nodes, self.n_clients, self.ops_per_client,
                self.intake, len(self.burst))


def pad_tplan(plan: TrafficPlan, n_burst: int) -> TrafficPlan:
    """``plan`` with its burst-window axis padded to ``n_burst`` by
    never-active ``[0, 0)`` windows (evaluation is unchanged)."""
    b = len(plan.b_starts)
    if b > n_burst:
        raise ValueError(
            f"plan has {b} burst windows, cannot pad to {n_burst}")
    pad = (0,) * (n_burst - b)
    return plan._replace(b_starts=plan.b_starts + pad,
                         b_ends=plan.b_ends + pad, b_num=plan.b_num + pad)


# the reference plan's leaf dtypes, in its field order
TPLAN_DTYPES = (np.int32, np.uint32, np.int32, np.int32, np.int32,
                np.uint32, np.uint32)


def batch_bursts(specs, n_burst: int | None = None) -> int:
    """The padded burst-window count of a batch of ``specs`` (``n_burst``
    when given, else the widest spec's), after the batch's checks: at
    least one spec, one static shape, ``n_burst`` no narrower than the
    widest spec."""
    if not specs:
        raise ValueError("batch_tplans needs at least one spec")
    key = specs[0].program_key[:4]
    for sp in specs:
        if sp.program_key[:4] != key:
            raise ValueError(
                "traffic batch mixes static shapes "
                f"{key} and {sp.program_key[:4]} — n_nodes, "
                "n_clients, ops_per_client and intake must be "
                "uniform across a batch (rate/seed/kind/until/burst "
                "values ride the traced plan)")
    b_max = max(len(sp.burst) for sp in specs)
    if n_burst is not None:
        if n_burst < b_max:
            raise ValueError(
                f"n_burst={n_burst} < the batch's widest burst "
                f"count {b_max}")
        b_max = n_burst
    return b_max


def batch_tplans(specs, n_burst: int | None = None) -> TrafficPlan:
    """Compile, pad and stack ``specs`` into one :class:`TrafficPlan` of
    numpy leaves with a leading scenario axis (the reference's batched
    plan: scalars (S,), burst windows (S, B)); ``n_burst`` sets the
    padded window count.  The serving batches drive each cell with its
    own plan (``specs[i].compile()``); this is the batch's record of
    them."""
    specs = list(specs)
    b_max = batch_bursts(specs, n_burst)
    plans = [pad_tplan(sp.compile(), b_max) for sp in specs]
    return TrafficPlan(*(
        np.array([p[i] for p in plans], dt).reshape(
            (len(plans), b_max) if i in (3, 4, 5) else (len(plans),))
        for i, dt in enumerate(TPLAN_DTYPES)))


# -- arrival evaluation --------------------------------------------------


def _client_hash(plan: TrafficPlan, t: int, ids: torch.Tensor,
                 salt: int) -> torch.Tensor:
    """int64 in [0, 2^32): the counter-based stream h(seed, t, client,
    salt) over the client ids (the faults edge-hash family)."""
    k = ((t & MASK32) * _K_T & MASK32) ^ plan.seed ^ salt
    return faults._mix32(faults._mul32(ids.to(torch.int64) & MASK32, _K_ID)
                         ^ k)


def _arrival_num(plan: TrafficPlan, t: int) -> int:
    """The uint32 arrival threshold at round ``t``: the base rate,
    overridden inside an active burst window (the last one wins)."""
    return windows_fold(plan.b_starts, plan.b_ends, t,
                        lambda w, num: plan.b_num[w], plan.rate_num)


def arrive(plan: TrafficPlan, t: int, ids: torch.Tensor) -> torch.Tensor:
    """bool, shaped like ``ids``: which client ids issue an op at round
    ``t`` — Bernoulli(rate) a (client, round) for ``poisson``; for
    ``constant`` the accumulator ``phase_c + t * rate_num (mod 2^32)``
    fires when adding another ``rate_num`` would wrap (an unsigned
    compare).  Nothing arrives outside ``[0, until)``; ``rate == 1``
    fires every round."""
    if not 0 <= t < plan.until:
        return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    num = _arrival_num(plan, t)
    if num == MASK32:
        return torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    if plan.kind == 1:
        phase = faults._mix32(
            faults._mul32(ids.to(torch.int64) & MASK32, _K_PHASE)
            ^ plan.seed ^ _SALT_PHASE)
        acc = (phase + (t * num & MASK32)) & MASK32
        return acc > (~num & MASK32)
    return _client_hash(plan, t, ids, _SALT_ARRIVE) < num


def local_node_cols(spec: TrafficSpec, n_loc: int,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """(n_loc,) int64: the node of each client — ``c // clients_per_node``
    when clients pack nodes, else ``c * node_stride``."""
    lc = torch.arange(n_loc, dtype=torch.int64, device=device)
    if spec.n_clients >= spec.n_nodes:
        return lc // spec.clients_per_node
    return lc * spec.node_stride


def client_index(spec: TrafficSpec, n_nodes: int, device) -> dict:
    """A traffic driver's per-spec index tensors: the client ids (int64), their
    home nodes (:func:`local_node_cols`) and the tracker's slab
    (:func:`traffic_block`).  Raises ValueError when ``spec`` is for
    another node count than the sim's ``n_nodes``."""
    if spec.n_nodes != n_nodes:
        raise ValueError(f"TrafficSpec is for {spec.n_nodes} nodes, sim "
                         f"has {n_nodes}")
    return dict(ids=torch.arange(spec.n_clients, dtype=torch.int64,
                                 device=device),
                node=local_node_cols(spec, spec.n_clients, device),
                block=traffic_block(spec.n_clients))


def intake_rank(arr: torch.Tensor, cpn: int) -> torch.Tensor:
    """(C,) int32: each arriving client's rank among this round's
    arrivals at its home node, in client order (the intake queue); 0
    everywhere with one client a node."""
    if cpn <= 1:
        return torch.zeros(arr.shape, dtype=torch.int32, device=arr.device)
    a = arr.reshape(-1, cpn).to(torch.int32)
    return (torch.cumsum(a, dim=1, dtype=torch.int32) - a).reshape(-1)


# -- the per-op tracker --------------------------------------------------


class TrafficState(NamedTuple):
    """Per-op completion tracker and backpressure counters.  Op identity
    is the static pair (client, k < ops_per_client)."""

    issued_k: torch.Tensor     # (C,) int32: next free op slot a client
    issue_round: torch.Tensor  # (C, K) int32: -1 until issued
    done_round: torch.Tensor   # (C, K) int32: -1 until globally visible
    # (C, K) int32 sim payload: Kafka the allocated slot, the counter the
    # KV value the op's flush landed in (-2: lost in an amnesia row)
    op_aux: torch.Tensor
    arrived: torch.Tensor      # () int64 holding a uint32
    deferred: torch.Tensor     # () int64: backpressured arrivals
    completed: torch.Tensor    # () int64
    deferred_resizing: torch.Tensor  # () int64: the resize sub-class

    def clone(self) -> "TrafficState":
        return TrafficState(*(x.clone() for x in self))


def state_specs(sharded: bool, axes="nodes"):
    """The reference's shard specs of a tracker: ROADMAP.md Queue A item
    10."""
    raise _unported("traffic.state_specs", 10)


def init_state(spec: TrafficSpec, mesh=None,
               device: str | torch.device | None = None) -> TrafficState:
    """An empty tracker on ``device`` (CUDA unless given); a ``mesh``
    raises (ROADMAP.md Queue A item 10)."""
    if mesh is not None:
        raise _unported("traffic.init_state(mesh=...)", 10)
    dev = resolve_device(device)
    c, k = spec.n_clients, spec.ops_per_client

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    def zero():
        return torch.zeros((), dtype=torch.int64, device=dev)

    return TrafficState(issued_k=full((c,), 0), issue_round=full((c, k), -1),
                        done_round=full((c, k), -1), op_aux=full((c, k), -1),
                        arrived=zero(), deferred=zero(), completed=zero(),
                        deferred_resizing=zero())


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int64)


def _set_slots(x: torch.Tensor, ok: torch.Tensor, kslot: torch.Tensor,
               vals) -> torch.Tensor:
    """A copy of (C, K) ``x`` with ``x[c, kslot[c]] = vals[c]`` where
    ``ok[c]`` — the reference's ``mode="drop"`` scatter: the other rows
    write back the value they hold (their slot clamped into range), so no
    index leaves the tensor and no mask is read on the host."""
    col = kslot.clamp(0, x.shape[1] - 1).to(torch.int64)[:, None]
    cur = x.gather(1, col)
    if isinstance(vals, torch.Tensor):
        vals = vals.to(x.dtype)[:, None]
    return x.scatter(1, col, torch.where(ok[:, None], vals, cur))


def issue(ts: TrafficState, arr: torch.Tensor, accept: torch.Tensor,
          t: int) -> tuple:
    """Classify this round's arrivals and record the issued ops: an
    arrival is issued iff ``accept`` holds and the client has a free op
    slot; every other one is deferred (counted, never dropped).  Returns
    ``(ts', ok, kslot)``: ``ok`` the issued mask, ``kslot`` the slot each
    issued arrival took (the counter before the bump)."""
    k = ts.issued_k
    n_k = ts.issue_round.shape[1]
    ok = arr & accept & (k < n_k)
    defer = arr & ~ok
    ts = ts._replace(
        issued_k=k + ok.to(torch.int32),
        issue_round=_set_slots(ts.issue_round, ok, k, t),
        arrived=(ts.arrived + _count(arr)) & MASK32,
        deferred=(ts.deferred + _count(defer)) & MASK32)
    return ts, ok, k


def record_aux(ts: TrafficState, ok: torch.Tensor, kslot: torch.Tensor,
               vals: torch.Tensor) -> TrafficState:
    """Store the sim payload of the ops just issued (Kafka's allocated
    slot)."""
    return ts._replace(op_aux=_set_slots(ts.op_aux, ok, kslot, vals))


def done_scan(ts: TrafficState, bit_fn: Callable, t_done: int,
              block: int | None = None) -> TrafficState:
    """Mark the ops that became globally visible this round:
    ``bit_fn(lo, block) -> (block, K) bool`` is the workload's visibility
    predicate for the client slab ``[lo, lo + block)`` (``block``: the
    ``GG_TRAFFIC_BLOCK`` slab, :func:`traffic_block`; any size gives the
    same result)."""
    rows = ts.issue_round.shape[0]
    block = rows if block is None else block
    dr = ts.done_round.clone()
    comp = torch.zeros((), dtype=torch.int64, device=dr.device)
    for lo in range(0, rows, block):
        dsl = dr[lo:lo + block]
        dn = ((ts.issue_round[lo:lo + block] >= 0) & (dsl < 0)
              & bit_fn(lo, block))
        comp = comp + _count(dn)
        dsl.masked_fill_(dn, t_done)
    return ts._replace(done_round=dr,
                       completed=(ts.completed + comp) & MASK32)


def resizing_defer(ts: TrafficState, arr,
                   reduce_sum: Callable | None = None) -> tuple:
    """The elastic-resharding intake gate: while a checkpoint-restore
    resize is in flight no op can be issued (the node axis itself changes
    shape), so every arrival of the round is deferred, counted in
    ``arrived``, ``deferred`` and the ``deferred_resizing`` sub-class
    (``arrived == issued + deferred`` still holds), and never dropped.
    Returns ``(ts', ok)``, ``ok`` the all-False issued mask of
    :func:`issue`'s shape.  ``reduce_sum`` is the identity off a mesh."""
    a = torch.as_tensor(arr, device=ts.arrived.device)
    n = a.to(torch.int64).sum() & MASK32
    if reduce_sum is not None:
        n = reduce_sum(n)
    ts = ts._replace(arrived=(ts.arrived + n) & MASK32,
                     deferred=(ts.deferred + n) & MASK32,
                     deferred_resizing=(ts.deferred_resizing + n) & MASK32)
    return ts, torch.zeros(a.shape, dtype=torch.bool, device=a.device)


def tel_series(ts: TrafficState) -> tuple:
    """The tracker's telemetry columns (``telemetry.TRAFFIC_SERIES``
    order): the running totals ``(arrived, issued, completed,
    deferred)`` after this round."""
    return (ts.arrived, _count(ts.issue_round >= 0), ts.completed,
            ts.deferred)


def traffic_block(rows: int) -> int:
    """Client-axis slab of :func:`done_scan`, from ``GG_TRAFFIC_BLOCK``
    (the reference's loud contract): a non-integer, or an integer that
    does not divide the client axis, raises naming the variable; values
    <= 0 or >= rows give the whole axis."""
    raw = os.environ.get("GG_TRAFFIC_BLOCK")
    if raw is None:
        return rows
    b = _env_int("GG_TRAFFIC_BLOCK", raw)
    if b <= 0 or b >= rows:
        return rows
    if rows % b != 0:
        raise ValueError(
            f"GG_TRAFFIC_BLOCK={b} does not divide the {rows}-row "
            "local client axis (the tracker scan needs even slabs); "
            "use a divisor, or unset it for the whole axis")
    return b


# -- host mirrors --------------------------------------------------------


def client_nodes(spec: TrafficSpec) -> np.ndarray:
    """(n_clients,) int32: each client's home node."""
    ids = np.arange(spec.n_clients, dtype=np.int64)
    if spec.n_clients >= spec.n_nodes:
        return (ids // spec.clients_per_node).astype(np.int32)
    return (ids * spec.node_stride).astype(np.int32)


def host_arrivals(spec: TrafficSpec, t: int) -> np.ndarray:
    """(n_clients,) bool: the numpy twin of :func:`arrive`."""
    if not 0 <= t < spec.until:
        return np.zeros(spec.n_clients, bool)
    num = np.uint32(faults._rate_to_num(spec.rate))
    for start, end, mult in spec.burst:
        if start <= t < end:
            num = np.uint32(faults._rate_to_num(
                min(1.0, spec.rate * mult)))
    seed = np.uint32(spec.seed & MASK32)
    ids = np.arange(spec.n_clients, dtype=np.int64).astype(np.uint32)
    t_term = np.uint32((int(t) * _K_T) & MASK32)
    if num == np.uint32(MASK32):
        return np.ones(spec.n_clients, bool)
    if spec.kind == "constant":
        phase = faults._mix32_np(
            ids * np.uint32(_K_PHASE) ^ seed ^ np.uint32(_SALT_PHASE))
        acc = phase + np.uint32((int(t) * int(num)) & MASK32)
        return acc > ~num
    h = faults._mix32_np(ids * np.uint32(_K_ID) ^ t_term
                         ^ seed ^ np.uint32(_SALT_ARRIVE))
    return h < num


def offered_per_round(spec: TrafficSpec) -> float:
    """Mean offered load in ops a round (rate x clients; burst windows
    raise the in-window mean)."""
    base = spec.rate * spec.n_clients
    if not spec.burst:
        return base
    boosted = sum((end - start) * (min(1.0, spec.rate * mult)
                                   - spec.rate) * spec.n_clients
                  for start, end, mult in spec.burst)
    return base + boosted / spec.until


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def latency_summary(ts: TrafficState) -> dict:
    """Host-side run report: op counts, the conservation verdict
    (``arrived == issued + deferred``, completed <= issued) and latency
    percentiles in rounds (p50 / p99 / max over completed ops)."""
    issue_r = _np(ts.issue_round)
    done_r = _np(ts.done_round)
    issued = int((issue_r >= 0).sum())
    comp_mask = done_r >= 0
    completed = int(comp_mask.sum())
    lat = (done_r[comp_mask] - issue_r[comp_mask]).astype(np.int64)
    arrived, deferred = int(ts.arrived), int(ts.deferred)
    return {
        "arrived": arrived, "issued": issued, "deferred": deferred,
        "deferred_resizing": int(ts.deferred_resizing),
        "completed": completed, "in_flight": issued - completed,
        "conserved": (arrived == issued + deferred
                      and int(ts.deferred_resizing) <= deferred
                      and completed == int(ts.completed)),
        "lat_p50": (float(np.percentile(lat, 50)) if completed
                    else None),
        "lat_p99": (float(np.percentile(lat, 99)) if completed
                    else None),
        "lat_max": int(lat.max()) if completed else None,
    }


def per_round_series(ts: TrafficState, n_rounds: int) -> dict:
    """Per-round issue and completion counts (completions a round
    collapse inside a fault window and recover after it clears)."""
    issue_r = _np(ts.issue_round)
    done_r = _np(ts.done_round)
    return {
        "issued_by_round": np.bincount(
            issue_r[issue_r >= 0], minlength=n_rounds).tolist(),
        "completed_by_round": np.bincount(
            done_r[done_r >= 0], minlength=n_rounds).tolist(),
    }
