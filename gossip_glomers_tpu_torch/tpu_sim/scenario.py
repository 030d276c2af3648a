"""Scenario batches on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/scenario.py — S independent nemesis
campaigns, or S serving cells, run as one batch.

A :class:`ScenarioBatch` holds S :class:`Scenario` cells (a
:class:`.faults.NemesisSpec`, for broadcast also a partition schedule and
per-edge delays, a workload seed) and the run shape they share; a
:class:`ServingBatch` holds S :class:`ServingCell` s (an open-loop
:class:`.traffic.TrafficSpec`, an optional nemesis, a topology).  Both are
JSON-able through ``to_meta`` / ``from_meta`` in the reference's form, so a
batch written by either package loads in the other.

Every scenario follows the sequential runner's campaign
(:func:`certify_loop`): from its clear round on it tests convergence
before each round and records its first converged round; it steps while
unconverged and below ``clear + max_recovery_rounds`` and then freezes, so
its final state, ledgers and telemetry ring are exactly where the
one-scenario runner (harness/nemesis.py ``run_*_nemesis``,
harness/serving.py ``run_serving``) stops.  All scenarios share the round
counter: an active scenario is at round t = the trip's iteration.

Two ways to run the scenario axis:

- **folded** (broadcast): the S scenarios run as ONE graph of S N node
  rows (:class:`.broadcast.FoldedBatch`): each round is one batched
  :func:`.kernels.fault_coins` and one :func:`.kernels.faulted_gather_round`
  over all scenarios, whatever S is; convergence, the first converged
  round, the freeze and the telemetry rows are (S,) device tensors, so
  :func:`dispatch_scenario_batch` only enqueues work and
  :func:`collect_scenario_batch` makes the one transfer;
- **looped** (counter, Kafka, txn and every serving batch): each scenario
  runs on its own sim under its own plan, once a round while active; the
  driver reads one (S,) flag tensor a round to freeze the converged ones.
  Their rounds carry per-scenario scalars (the counter's KV value and
  winner, Kafka's key tables, txn's registers, the serving tracker), whose
  fold is later work (ROADMAP.md).

The verdict rows go through :func:`.checkers.check_recovery_batch` (a
failing scenario is named by its index); with ``signatures`` each
scenario's (5,) behavioral signature is read from its telemetry ring when
the batch is collected (:func:`signature_eval`).

On a mesh (``mesh=``, a :class:`..parallel.mesh.Mesh`, every rank
calling) the batch is padded to a multiple of the rank count
(``pad_to_mesh``) and placed by :func:`.engine.scenario_placement`: each
rank runs its contiguous block of S / R whole scenarios (or serving
cells) through the one-process machinery above on its own device, with
no collective inside the trip, and the collect step gathers the ranks'
rows, stacked final states, telemetry series and signatures once, so
every rank returns the whole batch.  A scenario's node axis is never
sharded.

Not ported, and raising: the program audit (:func:`audit_contracts`,
``_audit_program``: ROADMAP.md Queue A item 14).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.topology import grid, to_padded_neighbors, tree
from . import broadcast as B
from . import counter as CT
from . import faults, telemetry, traffic
from . import kafka as KF
from . import txn as TX
from .engine import (check_mesh, host_unpack_bits, node_index,
                     node_shards, refuse_words, resolve_dcn_mode,
                     resolve_device, scenario_placement)

_TOPOLOGIES = {"grid": grid, "tree": tree}


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md Queue A item {item})")


def _refuse_stale_dcn(where: str, runner_kw: dict | None = None) -> None:
    """The batches run every scenario's node axis locally: a
    bounded-staleness ``dcn_mode`` (in ``runner_kw`` or the env) has no
    carry to ride and refuses loudly, as in the reference."""
    mode = resolve_dcn_mode((runner_kw or {}).get("dcn_mode"))
    if mode.stale_k:
        raise ValueError(
            f"dcn_mode={mode.label()!r}: {where} runs every "
            "scenario's node axis locally under scenario sharding — "
            "there is no DCN level inside a cell and no staleness "
            "carry threaded through the batch program, so bounded "
            "staleness is undecided here; run the batch sync or "
            "pipelined (or unset GG_DCN_STALE_K)")


# -- scenario cases ------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One cell of the fault space: ``spec`` the crash / loss / dup
    nemesis; ``parts`` an optional partition-schedule meta dict
    (broadcast, ``Partitions.to_meta``); ``delays`` an optional (N, D)
    per-edge delay matrix as nested tuples (broadcast); ``workload_seed``
    the Kafka and txn staging seed."""

    spec: faults.NemesisSpec
    parts: dict | None = None
    delays: tuple | None = None
    workload_seed: int = 0

    def __post_init__(self) -> None:
        if self.delays is not None:
            object.__setattr__(
                self, "delays",
                tuple(tuple(int(v) for v in row) for row in self.delays))

    def to_meta(self) -> dict:
        return {"spec": self.spec.to_meta(), "parts": self.parts,
                "delays": (None if self.delays is None
                           else [list(r) for r in self.delays]),
                "workload_seed": self.workload_seed}

    @staticmethod
    def from_meta(meta: dict) -> "Scenario":
        return Scenario(
            spec=faults.NemesisSpec.from_meta(meta["spec"]),
            parts=meta.get("parts"),
            delays=(None if meta.get("delays") is None
                    else tuple(tuple(r) for r in meta["delays"])),
            workload_seed=int(meta.get("workload_seed", 0)))


@dataclass(frozen=True)
class ScenarioBatch:
    """S scenarios and the run shape they share.  ``runner_kw``: the
    workload's static knobs (broadcast ``n_values`` / ``topology`` /
    ``sync_every``; counter ``mode`` / ``poll_every``; Kafka ``n_keys`` /
    ``capacity`` / ``max_sends`` / ``resync_every`` / ``rounds`` /
    ``send_prob``; txn ``n_keys`` / ``txns_per_node`` / ``ops_per_txn`` /
    ``rate`` / ``until`` / ``kv_amnesia``)."""

    workload: str
    scenarios: tuple = field(default_factory=tuple)
    runner_kw: dict = field(default_factory=dict)
    max_recovery_rounds: int = 64

    def __post_init__(self) -> None:
        if self.workload not in ("broadcast", "counter", "kafka", "txn"):
            raise ValueError(
                f"unknown scenario workload {self.workload!r}")
        if not self.scenarios:
            raise ValueError("a ScenarioBatch needs >= 1 scenario")
        object.__setattr__(self, "scenarios", tuple(
            sc if isinstance(sc, Scenario) else Scenario(spec=sc)
            for sc in self.scenarios))
        n = self.scenarios[0].spec.n_nodes
        for sc in self.scenarios:
            if sc.spec.n_nodes != n:
                raise ValueError(
                    "scenario batch mixes node counts "
                    f"{n} and {sc.spec.n_nodes}")

    @property
    def n_nodes(self) -> int:
        return self.scenarios[0].spec.n_nodes

    def to_meta(self) -> dict:
        return {"workload": self.workload,
                "scenarios": [sc.to_meta() for sc in self.scenarios],
                "runner_kw": dict(self.runner_kw),
                "max_recovery_rounds": self.max_recovery_rounds}

    @staticmethod
    def from_meta(meta: dict) -> "ScenarioBatch":
        return ScenarioBatch(
            workload=str(meta["workload"]),
            scenarios=tuple(Scenario.from_meta(m)
                            for m in meta["scenarios"]),
            runner_kw=dict(meta.get("runner_kw", {})),
            max_recovery_rounds=int(meta.get("max_recovery_rounds", 64)))


def pad_batch(batch: ScenarioBatch, multiple: int) -> tuple:
    """(padded batch, n_real): the scenario list padded up to a multiple
    of ``multiple`` with inert fault-free fillers (zero-rate, windowless;
    dropped from the results)."""
    s = len(batch.scenarios)
    if multiple <= 1 or s % multiple == 0:
        return batch, s
    pad = multiple - s % multiple
    filler = Scenario(spec=faults.NemesisSpec(n_nodes=batch.n_nodes))
    if any(sc.delays is not None for sc in batch.scenarios):
        d0 = next(sc.delays for sc in batch.scenarios
                  if sc.delays is not None)
        filler = Scenario(spec=filler.spec,
                          delays=tuple(tuple(1 for _ in row) for row in d0))
    return ScenarioBatch(
        workload=batch.workload,
        scenarios=batch.scenarios + (filler,) * pad,
        runner_kw=batch.runner_kw,
        max_recovery_rounds=batch.max_recovery_rounds), s


# -- batched operands ----------------------------------------------------


class BatchPartitions(NamedTuple):
    """S partition schedules padded to P windows and stacked: ``starts``
    / ``ends`` (S, P) int32 host arrays, ``group`` (S, P, N) int8."""

    starts: np.ndarray
    ends: np.ndarray
    group: torch.Tensor


def batch_partitions(metas, n_nodes: int,
                     device: str | torch.device = "cpu") -> BatchPartitions:
    """Pad and stack per-scenario partition schedules (meta dicts, None
    for none) into one :class:`BatchPartitions` on ``device``.  A pad
    window is the never-active ``[0, 0)`` with an all-zero group row."""
    parts = [B.Partitions.none(n_nodes) if m is None
             else B.Partitions.from_meta(m) for m in metas]
    p_max = max(p.n_windows for p in parts)
    s = len(parts)
    starts = np.zeros((s, p_max), np.int32)
    ends = np.zeros((s, p_max), np.int32)
    group = torch.zeros((s, p_max, n_nodes), dtype=torch.int8)
    for i, p in enumerate(parts):
        c = p.n_windows
        starts[i, :c] = p.starts
        ends[i, :c] = p.ends
        group[i, :c] = p.group.cpu()
    return BatchPartitions(starts, ends, group.to(device))


def stack_pytrees(trees):
    """Stack identically-structured states (named tuples, dataclasses or
    tuples) leaf by leaf along a new leading scenario axis: tensors with
    ``torch.stack``, host ints and arrays as numpy, None stays None."""
    first = trees[0]

    def stack(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(list(xs))
        if isinstance(xs[0], tuple) or dataclasses.is_dataclass(xs[0]):
            return stack_pytrees(xs)
        return np.stack([np.asarray(x) for x in xs])

    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)})
    if hasattr(first, "_fields"):
        return type(first)(*(stack([getattr(t, f) for t in trees])
                             for f in first._fields))
    return tuple(stack([t[j] for t in trees]) for j in range(len(first)))


def stage_kafka_batch(batch: ScenarioBatch, rounds: int, *, n_keys: int,
                      max_sends: int, send_prob: float,
                      quiesce: int = 0) -> tuple:
    """(S, R, N, Smax) send keys and values for a Kafka scenario batch:
    per scenario exactly the commit-free staging of
    ``harness.nemesis.stage_kafka_ops`` (so the sequential runner replays
    the same campaign), padded with -1 no-op rounds from the scenario's
    own clear round to ``rounds``.  numpy int32."""
    from ..harness.nemesis import stage_kafka_ops

    sks_all, svs_all = [], []
    for sc in batch.scenarios:
        r_s = max(sc.spec.clear_round,
                  int(batch.runner_kw.get("rounds") or 0))
        sks, svs, _crs = stage_kafka_ops(
            sc.spec, r_s, n_keys=n_keys, max_sends=max_sends,
            send_prob=send_prob, workload_seed=sc.workload_seed,
            commits=False, quiesce=quiesce)
        if r_s < rounds:
            pad = rounds - r_s
            n = sc.spec.n_nodes
            sks = np.concatenate(
                [sks, np.full((pad, n, max_sends), -1, np.int32)])
            svs = np.concatenate(
                [svs, np.zeros((pad, n, max_sends), np.int32)])
        sks_all.append(sks)
        svs_all.append(svs)
    return np.stack(sks_all), np.stack(svs_all)


# -- the looped drivers --------------------------------------------------


def _trip(steps, tests, carries, clears, max_rec: int, r_total: int,
          due) -> dict:
    """The looped batches' shared trip over S scenarios, each carry a
    tuple whose first element is its sim's state: each iteration first
    tests every scenario whose test is ``due(k, t)`` at its round, not
    yet passed and not yet taken at that round (``tests[k](carry)``, one
    read of the stacked flags), records the FIRST passing round and the
    ledger at the clear round, then steps every scenario still active
    (not passed, below ``clear + max_rec``: ``steps[k](carry) ->
    carry``); a frozen scenario is never stepped again."""
    s = len(carries)
    carries = list(carries)
    first, mc, tested = [-1] * s, [None] * s, [-1] * s
    syncs = trips = 0

    def check():
        nonlocal syncs
        idx = [k for k in range(s)
               if first[k] < 0 and due(k, carries[k][0].t)
               and tested[k] != carries[k][0].t]
        if not idx:
            return
        flags = torch.stack([tests[k](carries[k]) for k in idx]).cpu()
        syncs += 1
        for k, f in zip(idx, flags.tolist()):
            tested[k] = carries[k][0].t
            if f:
                first[k] = carries[k][0].t

    for _ in range(r_total):
        check()
        for k in range(s):
            if mc[k] is None and carries[k][0].t == clears[k]:
                mc[k] = carries[k][0].msgs.clone()
        active = [k for k in range(s)
                  if first[k] < 0 and carries[k][0].t < clears[k] + max_rec]
        if not active:
            break
        trips += 1
        for k in active:
            carries[k] = steps[k](carries[k])
    check()
    return {"carries": carries, "first": first,
            "msgs_clear": [0 if m is None else int(m) for m in mc],
            "syncs": syncs, "trips": trips}


def certify_loop(steps, convs, states, clears, max_rec: int,
                 r_total: int, tels=None) -> dict:
    """The looped workloads' campaign over S scenarios, each on its own
    sim (the reference's per-scenario ``certify_loop``): from its clear
    round on a scenario tests convergence before each round
    (``convs[k](state)``, a () bool tensor), records its FIRST converged
    round and steps (``steps[k](state, tel) -> (state, tel)``) while
    unconverged and below ``clear + max_rec``.  Returns the states, rings,
    ``conv_round`` (-1: never within bound), ``msgs_clear`` and the
    trip's ``syncs`` and ``trips``."""
    tels = list(tels) if tels is not None else [None] * len(states)
    out = _trip([lambda c, f=f: f(*c) for f in steps],
                [lambda c, f=f: f(c[0]) for f in convs],
                list(zip(states, tels)), clears, max_rec, r_total,
                lambda k, t: t >= clears[k])
    return dict(out, states=[c[0] for c in out["carries"]],
                tels=[c[1] for c in out["carries"]],
                conv_round=out["first"])


# -- verdicts and signatures ---------------------------------------------


def _verdict_rows(batch: ScenarioBatch, conv_round, msgs_clear,
                  msgs_final, lost_lists, extra=None) -> dict:
    """The batch result: per-scenario verdict rows through
    :func:`.checkers.check_recovery_batch` (a failing scenario is named by
    its index)."""
    from ..harness.checkers import check_recovery_batch

    clears = np.array([sc.spec.clear_round for sc in batch.scenarios],
                      np.int64)
    ok, det = check_recovery_batch(
        clear_rounds=clears,
        converged_rounds=np.asarray(conv_round, np.int64),
        max_recovery_rounds=batch.max_recovery_rounds,
        lost_writes=lost_lists,
        msgs_at_clear=np.asarray(msgs_clear, np.int64),
        msgs_at_converged=np.asarray(msgs_final, np.int64))
    rows = []
    for i, sc in enumerate(batch.scenarios):
        row = dict(det["scenarios"][i])
        row.update(workload=batch.workload, scenario=i,
                   spec=sc.spec.to_meta(),
                   msgs_total=int(np.asarray(msgs_final)[i]))
        if sc.parts is not None:
            row["parts"] = sc.parts
        if sc.delays is not None:
            row["delays"] = [list(r) for r in sc.delays]
        if extra is not None:
            row.update(extra[i])
        rows.append(row)
    return {"ok": ok, "workload": batch.workload,
            "n_scenarios": len(rows), "failing": det["failing"],
            "scenarios": rows}


def _sig_setup(telemetry_spec, r_total: int, extra_series=()):
    """The signature's ring checks: it exists, covers the whole horizon
    unwrapped (row t is round t) and records every column read; returns
    (msgs_col, progress_col)."""
    if telemetry_spec is None:
        raise ValueError(
            "signatures=True needs a telemetry_spec — the behavioral "
            "signature is derived from the telemetry ring (no new "
            "host callbacks)")
    if telemetry_spec.rounds < r_total:
        raise ValueError(
            f"signature ring must cover the whole horizon without "
            f"wrapping: rounds={telemetry_spec.rounds} < "
            f"r_total={r_total}")
    cols = telemetry.signature_columns(telemetry_spec)
    missing = [s for s in extra_series if s not in telemetry_spec.series]
    if missing:
        raise ValueError(
            f"behavioral signatures for workload "
            f"{telemetry_spec.workload!r} also need series {missing} "
            f"recorded; got series={list(telemetry_spec.series)}")
    return cols


def _last_row(ring: np.ndarray, wrote: int) -> np.ndarray:
    return ring[max(min(int(wrote), ring.shape[0]) - 1, 0)]


def signature_eval(ring, wrote: int, conv_round: int, clear: int,
                   bp_class: int, msgs_col: int, progress_col: int,
                   churn: int = 0) -> np.ndarray:
    """One scenario's (5,) int32 behavioral signature from its ring (an
    (R, width) array or tensor, ``wrote`` rows recorded), read on the
    host when the batch is collected: ``[stall_bucket, depth_bucket,
    bp_class, recovery_bucket, churn_bucket]`` — the log2 buckets of the
    first pre-convergence round whose msgs ledger went quiet
    (:func:`.telemetry.ring_stall_round`), of the last round the progress
    gauge moved (:func:`.telemetry.ring_progress_depth`), the caller's
    backpressure class, the recovery length (127: never converged) and
    the plan's membership events."""
    ring = torch.as_tensor(np.asarray(ring))
    cr = int(conv_round)
    stall = telemetry.ring_stall_round(ring, wrote, msgs_col, cr)
    depth = telemetry.ring_progress_depth(ring, wrote, progress_col)
    rec_b = telemetry.log2_bucket(max(cr - clear, 0)) if cr >= 0 else 127
    return np.array([telemetry.log2_bucket(stall),
                     telemetry.log2_bucket(depth), int(bp_class), rec_b,
                     telemetry.log2_bucket(int(churn))], np.int32)


def _i32(x) -> int:
    """A recorded uint32 ring value as the reference's int32 cast."""
    return int(np.asarray(x, np.int64).astype(np.uint32).view(np.int32))


def _tel_result(res: dict, rings: list, wrote: list, spec) -> None:
    res["telemetry"] = [
        telemetry.series_arrays(telemetry.TelemetryState(
            torch.as_tensor(np.asarray(r)), int(w)), spec)
        for r, w in zip(rings, wrote)]


# -- broadcast: the folded batch -----------------------------------------


def _dispatch_broadcast_batch(batch: ScenarioBatch, *,
                              telemetry_spec=None, signatures: bool = False,
                              n_windows: int | None = None,
                              min_rounds: int = 0, delay_set=None,
                              device=None) -> dict:
    """Stage the S broadcast campaigns as one :class:`.broadcast.
    FoldedBatch` (:func:`stage_broadcast_batch`) and enqueue every round
    of the trip (:func:`broadcast_trip`): convergence, the first
    converged round, the clear-round ledger, the freeze and the
    telemetry rows stay on the device, so the trip makes no host sync
    and :func:`_collect_broadcast_batch` makes the one transfer.
    ``n_windows`` pads every plan to that many crash windows and
    ``min_rounds`` floors the trip: both leave the rows unchanged;
    ``delay_set`` (:func:`_batch_delays`) is a whole batch's, for a
    rank's block of it."""
    return broadcast_trip(stage_broadcast_batch(
        batch, telemetry_spec=telemetry_spec, signatures=signatures,
        n_windows=n_windows, min_rounds=min_rounds, delay_set=delay_set,
        device=device))


def _batch_nbrs(batch: ScenarioBatch) -> np.ndarray:
    return to_padded_neighbors(_TOPOLOGIES[batch.runner_kw.get(
        "topology", "grid")](batch.n_nodes))


def _batch_delays(batch: ScenarioBatch, nbrs_np: np.ndarray,
                  delay_set=None) -> tuple:
    """(the (S, N, D) per-edge delays or None, their distinct values): a
    scenario without delays runs all-1 delays in a batch where any has
    them.  ``delay_set``: a whole batch's values, which a rank's block of
    it takes so that every block runs the delay ring the whole batch
    runs (one ring length, one mode)."""
    scs = batch.scenarios
    if delay_set is None and all(sc.delays is None for sc in scs):
        return None, ()
    dmats = []
    for sc in scs:
        d = (np.asarray(sc.delays, np.int32) if sc.delays is not None
             else np.ones(nbrs_np.shape, np.int32))
        if d.shape != nbrs_np.shape:
            raise ValueError(
                f"scenario delays shape {d.shape} != adjacency "
                f"{nbrs_np.shape}")
        dmats.append(np.where(nbrs_np >= 0, d, 1))
    delays = np.stack(dmats)
    if delay_set is None:
        delay_set = tuple(int(v) for v in np.unique(delays))
    return delays, tuple(delay_set)


def stage_broadcast_batch(batch: ScenarioBatch, *, telemetry_spec=None,
                          signatures: bool = False,
                          n_windows: int | None = None, min_rounds: int = 0,
                          delay_set=None, device=None) -> dict:
    """The folded batch's operands and round-0 carry on ``device`` (the
    host-to-device copies of a dispatch): a dict :func:`broadcast_trip`
    runs."""
    dev = resolve_device(device)
    kw = batch.runner_kw
    n = batch.n_nodes
    nv = int(kw.get("n_values") or 2 * n)
    topology = kw.get("topology", "grid")
    sync_every = int(kw.get("sync_every", 4))
    nbrs_np = _batch_nbrs(batch)
    scs = batch.scenarios
    s_count = len(scs)
    has_mem = any(sc.spec.has_membership for sc in scs)
    delays, delay_set = _batch_delays(batch, nbrs_np, delay_set)
    plans = faults.batch_plans([sc.spec for sc in scs], n_windows,
                               device=dev)
    parts_b = batch_partitions([sc.parts for sc in scs], n, device=dev)
    clears_np = np.array(_trip_clears(batch), np.int64)
    r_total = _r_total(clears_np, batch, min_rounds)
    # values are acked where they are injected: a pre-join row stages
    # nothing, so its round-robin values are never offered
    founding = np.stack([sc.spec.host_members(0) for sc in scs])
    inject = B.make_inject(n, nv)
    injs_np = np.where(founding[:, :, None], inject[None], np.uint32(0))
    targets_np = np.bitwise_or.reduce(injs_np, axis=1)       # (S, W)
    fb = B.FoldedBatch(nbrs_np, plan=plans, pstarts=parts_b.starts,
                       pends=parts_b.ends, group=parts_b.group,
                       sync_every=sync_every, rounds=r_total,
                       delays=delays, delay_set=delay_set, device=dev)
    st = fb.init_state(injs_np)
    target = fb.rows(torch.from_numpy(np.ascontiguousarray(
        targets_np.astype(np.uint32)).view(np.int32)).to(dev)[:, None, :]
        .expand(s_count, n, -1))
    target = target.reshape(s_count * n, -1)
    member = fb.rows(torch.from_numpy(np.stack(
        [sc.spec.host_members(sc.spec.clear_round) for sc in scs])).to(dev)
        if has_mem else torch.ones(s_count, dtype=torch.bool, device=dev))
    clear = torch.from_numpy(clears_np).to(dev)
    bound = clear + batch.max_recovery_rounds
    cr = torch.full((s_count,), -1, dtype=torch.int64, device=dev)
    mc = torch.zeros(s_count, dtype=torch.int64, device=dev)
    t_s = torch.zeros(s_count, dtype=torch.int64, device=dev)
    ring = (torch.zeros((s_count, telemetry_spec.rounds,
                         telemetry_spec.width), dtype=torch.int64,
                        device=dev) if telemetry_spec is not None else None)
    if signatures:
        _sig_setup(telemetry_spec, r_total)
    return {"batch": batch, "telemetry_spec": telemetry_spec,
            "signatures": signatures, "n": n, "nv": nv,
            "topology": topology, "targets_np": targets_np, "fb": fb,
            "state": st, "target": target, "member": member,
            "clear": clear, "bound": bound, "conv_round": cr,
            "msgs_clear": mc, "t": t_s, "ring": ring, "plans": plans,
            "rounds": r_total, "s_count": s_count}


def broadcast_trip(staged: dict) -> dict:
    """Enqueue every round of a staged folded batch's trip; returns the
    handle :func:`_collect_broadcast_batch` reads.  No host sync: every
    round's decisions are (S,) device tensors, and what the host reads
    (which windows and streams are active at round t) it reads from the
    plans' host arrays."""
    fb, st = staged["fb"], staged["state"]
    target, member = staged["target"], staged["member"]
    clear, bound = staged["clear"], staged["bound"]
    cr, mc, t_s = staged["conv_round"], staged["msgs_clear"], staged["t"]
    ring = staged["ring"]
    spec = staged["telemetry_spec"]
    tl = spec is not None
    mask = spec.static_mask if tl else None

    def check(st, cr, t_s):
        conv = B._batch_converged(fb, st, target, member)
        return torch.where((t_s >= clear) & (cr < 0) & conv, t_s, cr)

    for i in range(staged["rounds"]):
        cr = check(st, cr, t_s)
        mc = torch.where(t_s == clear, st.msgs, mc)
        active = (cr < 0) & (t_s < bound)
        fr0 = fb.popcounts(st.frontier) if tl and mask[1] else None
        st, up = fb.round(st, i, active)
        if tl:
            r = i % ring.shape[1]
            ring[:, r] = torch.where(active[:, None],
                                     fb.tel_row(i, fr0, st, up, mask),
                                     ring[:, r])
        t_s = t_s + active.to(torch.int64)
    cr = check(st, cr, t_s)
    return dict(staged, state=st, conv_round=cr, msgs_clear=mc, t=t_s,
                ring=ring)


def _collect_broadcast_batch(handle: dict) -> dict:
    """Read a dispatched broadcast batch back (the one transfer) and
    certify it: lost acked writes are values of the scenario's target
    that no member row holds at its clear round's membership."""
    batch = handle["batch"]
    spec = handle["telemetry_spec"]
    n, nv, s_count = handle["n"], handle["nv"], handle["s_count"]
    st = handle["state"]
    rec = st.received.cpu().numpy().view(np.uint32).reshape(s_count, n, -1)
    conv = handle["conv_round"].cpu().numpy()
    mc = handle["msgs_clear"].cpu().numpy()
    msgs = st.msgs.cpu().numpy()
    wrote = handle["t"].cpu().numpy()
    members = np.stack([sc.spec.host_members(sc.spec.clear_round)
                        for sc in batch.scenarios])
    targets_np = handle["targets_np"]
    anywhere = np.bitwise_or.reduce(
        np.where(members[:, :, None], rec, np.uint32(0)), axis=1)
    missing = host_unpack_bits(targets_np.astype(np.uint32) & ~anywhere, nv)
    lost_lists = [np.nonzero(missing[i])[0].tolist() for i in range(s_count)]
    res = _verdict_rows(batch, conv, mc, msgs, lost_lists)
    w = rec.shape[2]
    final = B.BatchState(
        received=st.received.view(s_count, n, w),
        frontier=st.frontier.view(s_count, n, w), msgs=st.msgs,
        history=(None if st.history is None else st.history.view(
            st.history.shape[0], s_count, n, w)))
    res.update(n_nodes=n, n_values=nv, topology=handle["topology"],
               final=final, rounds=handle["rounds"])
    if spec is not None:
        rings = handle["ring"].cpu().numpy()
        _tel_result(res, list(rings), list(wrote), spec)
    if handle["signatures"]:
        ms_col, pg_col = telemetry.signature_columns(spec)
        kn_col = spec.names.index("known_bits")
        churn = faults.batch_churn(handle["plans"])
        sigs = []
        for i, sc in enumerate(batch.scenarios):
            known = _i32(_last_row(rings[i], wrote[i])[kn_col])
            bp = telemetry.log2_bucket(max(n * nv - known, 0))
            sigs.append(signature_eval(rings[i], wrote[i], conv[i],
                                       sc.spec.clear_round, bp, ms_col,
                                       pg_col, churn[i]))
        res["signatures"] = np.stack(sigs)
    return res


def run_broadcast_batch(batch: ScenarioBatch, **kw) -> dict:
    """S broadcast campaigns as one folded batch: values injected
    round-robin at round 0, convergence = every member row holds every
    value, lost acked writes = values absent from every member row.  The
    fault space a scenario: crash / loss / dup (``spec``) x partition
    windows (``parts``) x per-edge delays (``delays``, the history-ring
    gather path).  Returns the verdict dict (:func:`_verdict_rows`), with
    ``telemetry_spec`` the per-scenario series and with ``signatures``
    the (S, 5) signature matrix.  ``kw``: :func:`_dispatch`'s (``mesh``
    places the batch, unpadded)."""
    return _collect(_dispatch(batch, **kw))


# -- counter, Kafka and txn: the looped batches --------------------------


def _r_total(clears, batch, min_rounds) -> int:
    return max(int(max(clears)) + batch.max_recovery_rounds,
               int(min_rounds))


def _trip_clears(batch: ScenarioBatch) -> list:
    """Each scenario's clear round, past which its convergence is tested:
    the spec's, and for Kafka the staged rounds', for txn the arrival
    horizon's too (the sequential runners' clears)."""
    floor = 0
    if batch.workload == "kafka":
        floor = int(batch.runner_kw.get("rounds") or 0)
    elif batch.workload == "txn":
        floor = _txn_kw(batch)["until"]
    return [max(sc.spec.clear_round, floor) for sc in batch.scenarios]


def _tel_rings(loop: dict):
    """(rings, wrote) of a looped batch's telemetry."""
    return ([t.ring.cpu().numpy() for t in loop["tels"]],
            [int(t.wrote) for t in loop["tels"]])


def _dispatch_counter_batch(batch: ScenarioBatch, *,
                            telemetry_spec=None, signatures: bool = False,
                            n_windows: int | None = None,
                            min_rounds: int = 0, device=None) -> dict:
    """Run S g-counter campaigns, each on its own :class:`.counter.
    CounterSim` under its own plan (:func:`certify_loop`)."""
    dev = resolve_device(device)
    kw = batch.runner_kw
    n = batch.n_nodes
    mode = kw.get("mode", "cas")
    poll_every = int(kw.get("poll_every", 2))
    scs = batch.scenarios
    has_mem = any(sc.spec.has_membership for sc in scs)
    plans = faults.batch_plans([sc.spec for sc in scs], n_windows,
                               device=dev)
    deltas = np.arange(1, n + 1, dtype=np.int32)
    # deltas are acked where they are staged: a pre-join row stages none
    founding = np.stack([sc.spec.host_members(0) for sc in scs])
    deltas_s = np.where(founding, deltas[None], 0).astype(np.int32)
    ackeds = deltas_s.sum(axis=1)
    clears = _trip_clears(batch)
    r_total = _r_total(clears, batch, min_rounds)
    if signatures:
        _sig_setup(telemetry_spec, r_total, extra_series=("pending_total",))
    sims, states, convs, steps = [], [], [], []
    for i, sc in enumerate(scs):
        sim = CT.CounterSim(n, mode=mode, poll_every=poll_every,
                            fault_plan=plans.plan(i), device=dev)
        member = (torch.from_numpy(sc.spec.host_members(sc.spec.clear_round))
                  .to(dev) if has_mem else None)
        sims.append(sim)
        states.append(sim.add(sim.init_state(), deltas_s[i]))
        convs.append(lambda st, m=member: CT._batch_converged(st, m))
        rnd = CT._build_batch_round(sim)
        steps.append(lambda st, tl, rnd=rnd: rnd(st, tl, telemetry_spec))
    tels = ([telemetry.init_state(telemetry_spec, dev) for _ in scs]
            if telemetry_spec is not None else None)
    loop = certify_loop(steps, convs, states, clears,
                        batch.max_recovery_rounds, r_total, tels)
    return dict(batch=batch, telemetry_spec=telemetry_spec,
                signatures=signatures, loop=loop, n=n, mode=mode,
                ackeds=ackeds, plans=plans, rounds=r_total)


def _collect_counter_batch(handle: dict) -> dict:
    batch, loop = handle["batch"], handle["loop"]
    spec = handle["telemetry_spec"]
    ackeds = handle["ackeds"]
    states = loop["states"]
    kv = np.array([int(s.kv) for s in states], np.int64)
    pend = np.array([int(s.pending.sum(dtype=torch.int64))
                     for s in states], np.int64)
    shortfall = ackeds - kv - pend
    lost_lists = [([{"lost_sum": int(shortfall[i])}]
                   if shortfall[i] != 0 else [])
                  for i in range(len(states))]
    msgs = [int(s.msgs) for s in states]
    res = _verdict_rows(batch, loop["conv_round"], loop["msgs_clear"], msgs,
                        lost_lists,
                        extra=[{"acked_sum": int(ackeds[i]), "kv": int(kv[i])}
                               for i in range(len(states))])
    res.update(n_nodes=handle["n"], mode=handle["mode"],
               final=stack_pytrees(states), rounds=handle["rounds"],
               syncs=loop["syncs"], trips=loop["trips"])
    if spec is not None:
        rings, wrote = _tel_rings(loop)
        _tel_result(res, rings, wrote, spec)
    if handle["signatures"]:
        ms_col, pg_col = telemetry.signature_columns(spec)
        pd_col = spec.names.index("pending_total")
        churn = faults.batch_churn(handle["plans"])
        sigs = []
        for i, sc in enumerate(batch.scenarios):
            last = _last_row(rings[i], wrote[i])
            bp = telemetry.log2_bucket(max(
                int(ackeds[i]) - _i32(last[pg_col]) - _i32(last[pd_col]),
                0))
            sigs.append(signature_eval(
                rings[i], wrote[i], loop["conv_round"][i],
                sc.spec.clear_round, bp, ms_col, pg_col, churn[i]))
        res["signatures"] = np.stack(sigs)
    return res


def run_counter_batch(batch: ScenarioBatch, **kw) -> dict:
    """S g-counter campaigns: per-node deltas acked at round 0 (the
    sequential runner's ``arange(1, n + 1)``), convergence = pending
    drained and every cached read equal to the KV, lost acked writes =
    the ``acked_sum - kv - pending`` shortfall."""
    return _collect(_dispatch(batch, **kw))


def _dispatch_kafka_batch(batch: ScenarioBatch, *,
                          telemetry_spec=None, signatures: bool = False,
                          n_windows: int | None = None,
                          min_rounds: int = 0, device=None) -> dict:
    """Run S replicated-log campaigns, each on its own :class:`.kafka.
    KafkaSim` under its own plan, over the staged sends of
    :func:`stage_kafka_batch` (:func:`certify_loop`)."""
    dev = resolve_device(device)
    kw = batch.runner_kw
    n = batch.n_nodes
    n_keys = int(kw.get("n_keys", 4))
    capacity = int(kw.get("capacity", 64))
    max_sends = int(kw.get("max_sends", 2))
    resync_every = int(kw.get("resync_every", 4))
    send_prob = float(kw.get("send_prob", 0.7))
    scs = batch.scenarios
    has_mem = any(sc.spec.has_membership for sc in scs)
    plans = faults.batch_plans([sc.spec for sc in scs], n_windows,
                               device=dev)
    clears = _trip_clears(batch)
    r_total = _r_total(clears, batch, min_rounds)
    # a leaving node drains for a resync period before it goes
    quiesce = (resync_every + 2) if has_mem else 0
    sks, svs = stage_kafka_batch(batch, r_total, n_keys=n_keys,
                                 max_sends=max_sends, send_prob=send_prob,
                                 quiesce=quiesce)
    sks = torch.from_numpy(sks).to(dev)
    svs = torch.from_numpy(svs).to(dev)
    if signatures:
        _sig_setup(telemetry_spec, r_total, extra_series=("alloc_total",))
    states, convs, steps = [], [], []
    for i, sc in enumerate(scs):
        sim = KF.KafkaSim(n, n_keys, capacity=capacity, max_sends=max_sends,
                          resync_every=resync_every,
                          fault_plan=plans.plan(i), device=dev)
        mem = sc.spec.host_members(clears[i]) if has_mem else None
        member = torch.from_numpy(mem).to(dev) if has_mem else None
        first = int(np.argmax(mem)) if has_mem else 0
        states.append(sim.init_state())
        convs.append(lambda st, m=member, f=first: KF._batch_converged(
            st, m, f))
        rnd = KF._build_batch_round(sim)
        steps.append(lambda st, tl, rnd=rnd, i=i: rnd(
            st, sks[i, st.t], svs[i, st.t], tl, telemetry_spec))
    tels = ([telemetry.init_state(telemetry_spec, dev) for _ in scs]
            if telemetry_spec is not None else None)
    loop = certify_loop(steps, convs, states, clears,
                        batch.max_recovery_rounds, r_total, tels)
    return dict(batch=batch, telemetry_spec=telemetry_spec,
                signatures=signatures, loop=loop, n=n, n_keys=n_keys,
                plans=plans, rounds=r_total, clears=clears)


def _collect_kafka_batch(handle: dict) -> dict:
    batch, loop = handle["batch"], handle["loop"]
    spec = handle["telemetry_spec"]
    states = loop["states"]
    lost_lists, n_alloc = [], []
    for st in states:
        log_vals = st.log_vals.cpu().numpy()
        allocated = log_vals >= 0
        p = np.ascontiguousarray(st.present.cpu().numpy())
        bits = np.unpackbits(p.view(np.uint8), axis=-1, bitorder="little")
        anywhere = bits.any(axis=0)[:, :allocated.shape[1]]
        lost = [(int(k), int(c) + 1)
                for k, c in zip(*np.nonzero(allocated & ~anywhere))]
        kvv = st.kv_val.cpu().numpy()
        lc = st.local_committed.cpu().numpy()
        over = lc > np.where(kvv > 0, kvv, 0)[None, :]
        lost += [{"committed_over_cell": (int(a), int(b))}
                 for a, b in zip(*np.nonzero(over))]
        lost_lists.append(lost)
        n_alloc.append(int(allocated.sum()))
    msgs = [int(s.msgs) for s in states]
    res = _verdict_rows(batch, loop["conv_round"], loop["msgs_clear"], msgs,
                        lost_lists,
                        extra=[{"n_allocated": a} for a in n_alloc])
    res.update(n_nodes=handle["n"], n_keys=handle["n_keys"],
               final=stack_pytrees(states), rounds=handle["rounds"],
               syncs=loop["syncs"], trips=loop["trips"])
    if spec is not None:
        rings, wrote = _tel_rings(loop)
        _tel_result(res, rings, wrote, spec)
    if handle["signatures"]:
        ms_col, pg_col = telemetry.signature_columns(spec)
        al_col = spec.names.index("alloc_total")
        churn = faults.batch_churn(handle["plans"])
        sigs = []
        for i, sc in enumerate(batch.scenarios):
            last = _last_row(rings[i], wrote[i])
            bp = telemetry.log2_bucket(
                max(_i32(last[al_col]) - _i32(last[pg_col]), 0))
            sigs.append(signature_eval(
                rings[i], wrote[i], loop["conv_round"][i],
                handle["clears"][i], bp, ms_col, pg_col, churn[i]))
        res["signatures"] = np.stack(sigs)
    return res


def run_kafka_batch(batch: ScenarioBatch, **kw) -> dict:
    """S replicated-log campaigns: per-scenario seeded send traffic at
    live nodes (the sequential runner's ``commits=False`` staging), the
    faulted replication, convergence = every node's presence identical,
    lost acked writes = allocated slots present at no node (and any
    committed cache above its cell)."""
    return _collect(_dispatch(batch, **kw))


def _txn_kw(batch: ScenarioBatch) -> dict:
    kw = batch.runner_kw
    t_dim = int(kw.get("txns_per_node", 4))
    return dict(n_keys=int(kw.get("n_keys", 8)), txns_per_node=t_dim,
                ops_per_txn=int(kw.get("ops_per_txn", 2)),
                rate=float(kw.get("rate", 0.5)),
                until=int(kw.get("until") or 4 * t_dim),
                kv_amnesia=bool(kw.get("kv_amnesia", False)))


def _txn_checks(batch: ScenarioBatch, telemetry_spec,
                signatures: bool) -> None:
    """The txn batch's refusals (the reference's), over the whole batch
    (so a refused scenario is named by its index in it)."""
    if telemetry_spec is not None or signatures:
        raise ValueError(
            "the txn workload's observability record is the "
            "per-transaction stamp pair riding TxnState — telemetry "
            "rings / behavioral signatures are not wired for it")
    for i, sc in enumerate(batch.scenarios):
        if sc.spec.dup_rate:
            raise ValueError(
                "txn scenarios cannot carry dup streams "
                "(kvstore.reject_dup_stream: a re-applied CAS would "
                "double-commit)")
        if sc.spec.has_membership:
            raise ValueError(
                f"txn scenario {i} carries membership events "
                "(join/leave), which the txn workload does not "
                "support yet: the wound-or-die commit path and the "
                "per-transaction stamp ledger assume a fixed client "
                "roster — run membership churn on the "
                "broadcast/counter/kafka workloads instead")


def _dispatch_txn_batch(batch: ScenarioBatch, *,
                        telemetry_spec=None, signatures: bool = False,
                        n_windows: int | None = None,
                        min_rounds: int = 0, device=None) -> dict:
    """Run S txn-rw-register campaigns, each on its own :class:`.txn.
    TxnSim` (its own seeded transactions and arrivals, its own plan);
    serializability is certified when the batch is collected."""
    _txn_checks(batch, telemetry_spec, signatures)
    dev = resolve_device(device)
    n = batch.n_nodes
    tkw = _txn_kw(batch)
    scs = batch.scenarios
    plans = faults.batch_plans([sc.spec for sc in scs], n_windows,
                               device=dev)
    # convergence is meaningful only past both horizons (the sequential
    # runner's clear)
    clears = _trip_clears(batch)
    r_total = _r_total(clears, batch, min_rounds)
    sims, states, steps = [], [], []
    for i, sc in enumerate(scs):
        sim = TX.TxnSim(n, tkw["n_keys"],
                        txns_per_node=tkw["txns_per_node"],
                        ops_per_txn=tkw["ops_per_txn"], rate=tkw["rate"],
                        until=tkw["until"], workload_seed=sc.workload_seed,
                        fault_plan=plans.plan(i),
                        kv_amnesia=tkw["kv_amnesia"], device=dev)
        sims.append(sim)
        states.append(sim.init_state())
        rnd = TX._build_batch_round(sim)
        steps.append(lambda st, tl, rnd=rnd: (rnd(st), tl))
    loop = certify_loop(steps, [TX._batch_converged] * len(scs), states,
                        clears, batch.max_recovery_rounds, r_total)
    return dict(batch=batch, telemetry_spec=None, signatures=False,
                loop=loop, n=n, sims=sims, rounds=r_total)


def _collect_txn_batch(handle: dict) -> dict:
    """Certify a txn batch: the recovery rows and, per scenario, the
    serializability verdict over the recorded history (lost updates and
    lost acked commits are the row's lost writes; any other anomaly
    fails the row too)."""
    from ..harness.checkers import check_txn_serializable

    batch, loop, sims = handle["batch"], handle["loop"], handle["sims"]
    states = loop["states"]
    lost_lists, ser_rows = [], []
    for sim, st in zip(sims, states):
        hist = TX.history_of(st, sim.ops)
        ok_ser, det = check_txn_serializable(
            hist, final=TX.final_registers(st, sim.layout))
        lost_lists.append(
            [p for p in det["problems"]
             if p["kind"] in ("lost-update", "lost-acked-commit")])
        ser_rows.append({"serializable": ok_ser,
                         "ser_by_kind": det["by_kind"],
                         "n_txns": len(hist),
                         "n_committed": det["n_committed"]})
    msgs = [int(s.msgs) for s in states]
    res = _verdict_rows(batch, loop["conv_round"], loop["msgs_clear"], msgs,
                        lost_lists, extra=ser_rows)
    for i, row in enumerate(res["scenarios"]):
        if not ser_rows[i]["serializable"]:
            row["ok"] = False
    res["failing"] = [i for i, row in enumerate(res["scenarios"])
                      if not row["ok"]]
    res["ok"] = not res["failing"]
    res.update(n_nodes=handle["n"], final=stack_pytrees(states),
               rounds=handle["rounds"], syncs=loop["syncs"],
               trips=loop["trips"])
    return res


def run_txn_batch(batch: ScenarioBatch, **kw) -> dict:
    """S txn-rw-register campaigns: per-scenario seeded transactions and
    arrivals, wound-or-die commits on the device KV, convergence = every
    offered transaction committed, certification = bounded recovery AND a
    serializable recorded history with no lost acked commit."""
    return _collect(_dispatch(batch, **kw))


_DISPATCHERS = {"broadcast": _dispatch_broadcast_batch,
                "counter": _dispatch_counter_batch,
                "kafka": _dispatch_kafka_batch,
                "txn": _dispatch_txn_batch}
_COLLECTORS = {"broadcast": _collect_broadcast_batch,
               "counter": _collect_counter_batch,
               "kafka": _collect_kafka_batch,
               "txn": _collect_txn_batch}


def _block_of(items: tuple, mesh) -> tuple:
    """This rank's contiguous block of a placed batch's scenarios or
    cells."""
    b = len(items) // node_shards(mesh)
    return items[node_index(mesh) * b:(node_index(mesh) + 1) * b]


def _dispatch(batch: ScenarioBatch, *, mesh=None, telemetry_spec=None,
              signatures: bool = False, n_windows: int | None = None,
              min_rounds: int = 0, device=None) -> dict:
    """Run one batch through its workload's dispatcher on ``device``, or
    on a ``mesh`` (its device) by :func:`.engine.scenario_placement`:
    under ``"scenario"`` placement this rank runs its block of the
    scenarios, with the whole batch's crash-window count, trip length
    and delay ring (so that every block runs the program the whole batch
    runs, and the rows are the one-process batch's); under ``"single"``
    every rank runs the whole batch.  No collective either way."""
    wl = batch.workload
    check_mesh(mesh)
    refuse_words(mesh, "a scenario or serving batch")
    extra = {}
    placed = scenario_placement(len(batch.scenarios), mesh) == "scenario"
    if mesh is not None:
        device = mesh.device
    if placed:
        if wl == "txn":
            _txn_checks(batch, telemetry_spec, signatures)
        n_windows = faults.batch_windows([sc.spec for sc in batch.scenarios],
                                         n_windows)
        min_rounds = _r_total(_trip_clears(batch), batch, min_rounds)
        if wl == "broadcast":
            extra["delay_set"] = (_batch_delays(batch, _batch_nbrs(batch))[1]
                                  or None)
        batch = dataclasses.replace(
            batch, scenarios=_block_of(batch.scenarios, mesh))
    handle = _DISPATCHERS[wl](
        batch, telemetry_spec=telemetry_spec, signatures=signatures,
        n_windows=n_windows, min_rounds=min_rounds, device=device, **extra)
    handle["placed"] = mesh if placed else None
    return handle


def _collect(handle: dict) -> dict:
    """Certify a :func:`_dispatch` handle; a scenario-placed batch's
    ranks' results gathered into the whole batch's (one gather)."""
    res = _COLLECTORS[handle["batch"].workload](handle)
    mesh = handle.get("placed")
    if mesh is not None:
        res = _gather_blocks(res, mesh, "scenarios", "scenario",
                             "n_scenarios")
    return res


def _host(tree):
    """A result's tensors copied to the host (what crosses ranks)."""
    return _tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                     else x, tree)


def _tree_map(fn, tree):
    """``fn`` over the leaves (tensors, arrays) of a state tree (named
    tuples, dataclasses, tuples, lists and dicts; other leaves kept)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def _tree_cat(trees: list, device, dims: dict | None = None):
    """Stacked state trees (:func:`stack_pytrees`) of the ranks' blocks,
    concatenated along their scenario axis (axis 0, or ``dims[field]``)
    into one, its tensors on ``device``."""
    first = trees[0]
    dims = dims or {}

    def cat(xs, dim=0):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(list(xs), dim=dim).to(device)
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs, axis=dim)
        if isinstance(xs[0], tuple) or dataclasses.is_dataclass(xs[0]):
            return _tree_cat(list(xs), device)
        return xs[0]

    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: cat([getattr(t, f.name) for t in trees],
                        dims.get(f.name, 0))
            for f in dataclasses.fields(first)})
    if hasattr(first, "_fields"):
        return type(first)(*(cat([getattr(t, f) for t in trees],
                                 dims.get(f, 0)) for f in first._fields))
    return tuple(cat([t[j] for t in trees]) for j in range(len(first)))


def _gather_blocks(res: dict, mesh, rows_key: str, idx_key: str,
                   n_key: str) -> dict:
    """The whole batch's result from every rank's result over its block
    (one gather): the rows in rank order, each renumbered to its index
    in the batch, the failing indices and verdict recomputed from them,
    the telemetry series, the signatures and the stacked final states
    (and trackers) concatenated; the trip counters are the largest any
    rank's host made.  Every rank returns the same."""
    parts = mesh.all_gather_object(_host(res))
    out = dict(parts[0])
    rows = []
    for part in parts:
        off = len(rows)
        rows += [dict(r, **{idx_key: off + r[idx_key]})
                 for r in part[rows_key]]
    out[rows_key] = rows
    out[n_key] = len(rows)
    out["failing"] = [i for i, r in enumerate(rows) if not r["ok"]]
    out["ok"] = not out["failing"]
    if "telemetry" in out:
        out["telemetry"] = [x for part in parts for x in part["telemetry"]]
    if "signatures" in out:
        out["signatures"] = np.concatenate([part["signatures"]
                                            for part in parts])
    for key in ("syncs", "trips"):
        if key in out:
            out[key] = max(part[key] for part in parts)
    for key in ("final", "trackers"):
        if key in out:
            dims = ({"history": 1} if isinstance(out[key], B.BatchState)
                    else None)
            out[key] = _tree_cat([part[key] for part in parts],
                                 mesh.device, dims)
    return out


def dispatch_scenario_batch(batch: ScenarioBatch, *, mesh=None,
                            telemetry_spec=None, signatures: bool = False,
                            n_windows: int | None = None,
                            min_rounds: int = 0, pad_to: int | None = None,
                            pad_to_mesh: bool = True, device=None) -> dict:
    """Pad and run one :class:`ScenarioBatch` on ``device`` (CUDA unless
    given) and return its handle for :func:`collect_scenario_batch`.  The
    broadcast batch only enqueues its rounds here (no host sync); the
    looped workloads run their trip.  ``pad_to`` rounds the scenario
    count up to a multiple (the fillers are dropped when collected).
    ``mesh``: every rank calls; the batch is first padded to a multiple
    of the rank count (``pad_to_mesh``) and each rank runs its block of
    it (:func:`_dispatch`)."""
    _refuse_stale_dcn("a scenario batch")
    n_real = len(batch.scenarios)
    mult = node_shards(mesh) if mesh is not None and pad_to_mesh else 1
    if pad_to:
        mult = max(mult, int(pad_to))
    if mult > 1:
        batch, n_real = pad_batch(batch, mult)
    handle = _dispatch(batch, mesh=mesh, telemetry_spec=telemetry_spec,
                       signatures=signatures, n_windows=n_windows,
                       min_rounds=min_rounds, device=device)
    handle["n_real"] = n_real
    return handle


def collect_scenario_batch(handle: dict) -> dict:
    """Certify a dispatched scenario batch (on a mesh gathering the
    ranks' blocks, a collective call), dropping padding fillers from the
    rows, telemetry and signatures."""
    res = _collect(handle)
    n_real = handle["n_real"]
    if n_real < res["n_scenarios"]:
        res["scenarios"] = res["scenarios"][:n_real]
        res["failing"] = [i for i in res["failing"] if i < n_real]
        if "telemetry" in res:
            res["telemetry"] = res["telemetry"][:n_real]
        if "signatures" in res:
            res["signatures"] = res["signatures"][:n_real]
        res["n_scenarios"] = n_real
        res["ok"] = not res["failing"]
    return res


def run_scenario_batch(batch: ScenarioBatch, *, mesh=None,
                       telemetry_spec=None, signatures: bool = False,
                       n_windows: int | None = None, min_rounds: int = 0,
                       pad_to: int | None = None, pad_to_mesh: bool = True,
                       device=None) -> dict:
    """Run and certify one :class:`ScenarioBatch` — the fuzzer's unit of
    work.  ``signatures`` adds the (S, 5) signature matrix;
    ``n_windows`` / ``min_rounds`` / ``pad_to`` are the reference's
    shape-bucket knobs (pad crash windows, floor the trip, round the
    scenario count up), which leave every row unchanged; ``mesh`` /
    ``pad_to_mesh``: :func:`dispatch_scenario_batch`'s."""
    return collect_scenario_batch(dispatch_scenario_batch(
        batch, mesh=mesh, telemetry_spec=telemetry_spec,
        signatures=signatures, n_windows=n_windows, min_rounds=min_rounds,
        pad_to=pad_to, pad_to_mesh=pad_to_mesh, device=device))


# -- serving batches -----------------------------------------------------


@dataclass(frozen=True)
class ServingCell:
    """One (offered load x fault x topology) grid cell: ``traffic`` the
    cell's open-loop load (its client shape must match the batch's),
    ``spec`` the optional nemesis, ``topology`` the broadcast adjacency
    ("grid" / "tree"), ``coords`` grid coordinates echoed into the
    rows."""

    traffic: traffic.TrafficSpec
    spec: faults.NemesisSpec | None = None
    topology: str = "grid"
    coords: tuple = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "coords", tuple(self.coords))

    @property
    def clear_round(self) -> int:
        """``run_serving``'s clear: the traffic horizon, extended to the
        nemesis's clear round."""
        return max(self.traffic.until,
                   self.spec.clear_round if self.spec else 0)

    def to_meta(self) -> dict:
        return {"traffic": self.traffic.to_meta(),
                "spec": None if self.spec is None else self.spec.to_meta(),
                "topology": self.topology, "coords": list(self.coords)}

    @staticmethod
    def from_meta(meta: dict) -> "ServingCell":
        return ServingCell(
            traffic=traffic.TrafficSpec.from_meta(meta["traffic"]),
            spec=(None if meta.get("spec") is None
                  else faults.NemesisSpec.from_meta(meta["spec"])),
            topology=str(meta.get("topology", "grid")),
            coords=tuple(meta.get("coords", ())))


@dataclass(frozen=True)
class ServingBatch:
    """S serving cells and the static shape they share.  ``runner_kw``:
    broadcast ``n_values`` / ``sync_every``; counter ``mode`` /
    ``poll_every``; Kafka ``n_keys`` / ``capacity`` (required: the
    sequential default depends on the rate, and a batch mixes rates) /
    ``max_sends`` / ``resync_every``."""

    workload: str
    cells: tuple = field(default_factory=tuple)
    runner_kw: dict = field(default_factory=dict)
    max_recovery_rounds: int = 96
    drain_every: int = 8

    def __post_init__(self) -> None:
        if self.workload not in ("broadcast", "counter", "kafka"):
            raise ValueError(
                f"unknown serving workload {self.workload!r}")
        if not self.cells:
            raise ValueError("a ServingBatch needs >= 1 cell")
        if self.max_recovery_rounds < 1 or self.drain_every < 1:
            raise ValueError(
                "max_recovery_rounds and drain_every must be >= 1")
        object.__setattr__(self, "cells", tuple(self.cells))
        c0 = self.cells[0]
        key = c0.traffic.program_key[:4]
        for c in self.cells:
            if c.traffic.program_key[:4] != key:
                raise ValueError(
                    "serving batch mixes traffic statics "
                    f"{key} and {c.traffic.program_key[:4]} — the "
                    "client shape (n_nodes, n_clients, "
                    "ops_per_client, intake) is compiled; only "
                    "rate/kind/burst/seed/until ride the plan")
            if c.spec is not None and c.spec.n_nodes != c0.traffic.n_nodes:
                raise ValueError(
                    f"cell nemesis is for {c.spec.n_nodes} nodes, "
                    f"traffic for {c0.traffic.n_nodes}")

    @property
    def n_nodes(self) -> int:
        return self.cells[0].traffic.n_nodes

    def to_meta(self) -> dict:
        return {"workload": self.workload,
                "cells": [c.to_meta() for c in self.cells],
                "runner_kw": dict(self.runner_kw),
                "max_recovery_rounds": self.max_recovery_rounds,
                "drain_every": self.drain_every}

    @staticmethod
    def from_meta(meta: dict) -> "ServingBatch":
        return ServingBatch(
            workload=str(meta["workload"]),
            cells=tuple(ServingCell.from_meta(m) for m in meta["cells"]),
            runner_kw=dict(meta.get("runner_kw", {})),
            max_recovery_rounds=int(meta.get("max_recovery_rounds", 96)),
            drain_every=int(meta.get("drain_every", 8)))


def pad_serving_batch(batch: ServingBatch, multiple: int) -> tuple:
    """(padded batch, n_real): the last cell repeated up to a multiple of
    ``multiple`` (fillers are dropped from the results)."""
    s = len(batch.cells)
    if multiple <= 1 or s % multiple == 0:
        return batch, s
    pad = multiple - s % multiple
    return ServingBatch(
        workload=batch.workload, cells=batch.cells + (batch.cells[-1],) * pad,
        runner_kw=batch.runner_kw,
        max_recovery_rounds=batch.max_recovery_rounds,
        drain_every=batch.drain_every), s


def _all_done(tr) -> torch.Tensor:
    """() bool: every issued op completed."""
    return tr.completed >= tr.issued_k.sum(dtype=torch.int64)


def serving_loop(steps, states, trackers, clears, drain_every: int,
                 max_rec: int, r_total: int, tels=None) -> dict:
    """The serving cells' runs, each the twin of harness/serving.py
    ``run_serving``'s loop: driven unconditionally to its ``clear`` round
    (the ledger recorded there), then tested for "every issued op
    completed" only at the drain checkpoints the sequential loop observes
    (every ``drain_every`` rounds past clear, and at ``clear +
    max_rec``); the FIRST satisfied checkpoint is ``fr`` (-1: ops still
    open at the bound) and the cell freezes there or at the bound.
    ``steps[k](state, tracker, tel) -> (state, tracker, tel)`` is one
    round of cell k."""
    tels = list(tels) if tels is not None else [None] * len(states)

    def due(k, t):
        d = t - clears[k]
        return d >= 0 and (d % drain_every == 0 or d >= max_rec)

    out = _trip([lambda c, f=f: f(*c) for f in steps],
                [lambda c: _all_done(c[1])] * len(states),
                list(zip(states, trackers, tels)), clears, max_rec,
                r_total, due)
    carries = out["carries"]
    return dict(out, states=[c[0] for c in carries],
                trackers=[c[1] for c in carries],
                tels=[c[2] for c in carries], fr=out["first"])


def _serving_common(batch: ServingBatch, n_windows, n_burst,
                    min_rounds) -> tuple:
    """The host checks every serving batch shares, the reference's
    (one static traffic shape, one ``n_nodes``, ``n_burst`` /
    ``n_windows`` no narrower than the widest cell's plan, no
    membership), and (clear rounds, trip length).  Each cell runs its own
    sim under its own plans, so nothing is staged for the batch."""
    cells = batch.cells
    traffic.batch_bursts([c.traffic for c in cells], n_burst)
    n = batch.n_nodes
    specs = [c.spec if c.spec is not None else faults.NemesisSpec(n_nodes=n)
             for c in cells]
    for i, sp in enumerate(specs):
        if sp.has_membership:
            raise ValueError(
                f"serving cell {i} carries membership events "
                "(join/leave), which the serving batch path does not "
                "support yet: the open-loop traffic tracker has no "
                "join/leave-aware intake gating — run membership "
                "churn on the closed-loop scenario batches "
                "(dispatch_scenario_batch) instead")
    faults.batch_windows(specs, n_windows)
    clears = [c.clear_round for c in cells]
    r_total = max(max(clears) + batch.max_recovery_rounds, int(min_rounds))
    return clears, r_total


def _serving_sig(telemetry_spec, r_total: int):
    """The serving signature: the backpressure class from the tracker (0
    clean, 1 deferral-dominated, 2 in-flight-dominated), the stall and
    depth buckets from the ring."""
    ms_col, pg_col = _sig_setup(telemetry_spec, r_total)

    def sig_fn(tr, ring, wrote, fr, clear):
        inf = _i32(int(tr.issued_k.sum(dtype=torch.int64))
                   - int(tr.completed))
        de = _i32(int(tr.deferred))
        bp = 0 if de == 0 and inf == 0 else (1 if de >= inf else 2)
        return signature_eval(ring, wrote, fr, clear, bp, ms_col, pg_col)

    return sig_fn


def _serving_sim_kw(batch: ServingBatch, cell: ServingCell) -> dict:
    kw = batch.runner_kw
    tspec = batch.cells[0].traffic
    if batch.workload == "broadcast":
        return dict(topology=cell.topology,
                    n_values=int(kw.get("n_values")
                                 or tspec.n_clients * tspec.ops_per_client),
                    sync_every=int(kw.get("sync_every", 4)))
    if batch.workload == "counter":
        return dict(mode=kw.get("mode", "cas"),
                    poll_every=int(kw.get("poll_every", 2)))
    return dict(n_keys=int(kw.get("n_keys", 16)),
                capacity=int(kw["capacity"]),
                max_sends=int(kw.get("max_sends", 4)),
                resync_every=int(kw.get("resync_every", 4)))


def dispatch_serving_batch(batch: ServingBatch, *, mesh=None,
                           telemetry_spec=None, signatures: bool = False,
                           n_windows: int | None = None,
                           n_burst: int | None = None, min_rounds: int = 0,
                           pad_to_mesh: bool = True, device=None) -> dict:
    """Run a (load x fault x topology) serving grid on ``device``, each
    cell on its own sim under its own plan and traffic
    (:func:`serving_loop`); finish with :func:`collect_serving_batch`.
    ``telemetry_spec=True`` builds the default traffic ring sized to the
    horizon (what ``signatures`` needs).  ``n_windows`` / ``n_burst`` are
    checked as the reference checks them (no narrower than the widest
    cell's plan) and change nothing else: no plan is padded for a looped
    batch.  ``min_rounds`` raises the trip's length, which the loop
    leaves once every cell has frozen.  ``mesh``: every rank calls; the
    grid is padded to a multiple of the rank count (``pad_to_mesh``, the
    last cell repeated) and under scenario placement each rank runs its
    block of the cells, the whole grid's horizon and ring shape kept
    (:func:`.engine.scenario_placement`)."""
    from ..harness.serving import make_serving_sim

    _refuse_stale_dcn("a serving batch", batch.runner_kw)
    check_mesh(mesh)
    refuse_words(mesh, "a scenario or serving batch")
    n_real = len(batch.cells)
    if mesh is not None:
        device = mesh.device
        if pad_to_mesh:
            batch, n_real = pad_serving_batch(batch, node_shards(mesh))
    placed = scenario_placement(len(batch.cells), mesh) == "scenario"
    dev = resolve_device(device)
    if batch.workload == "kafka" and "capacity" not in batch.runner_kw:
        raise ValueError(
            "kafka serving batches need an explicit "
            "runner_kw['capacity']: the sequential default is "
            "sized from the cell's rate, and a frontier batch "
            "mixes rates (one compiled shape per batch)")
    clears, r_total = _serving_common(batch, n_windows, n_burst,
                                      min_rounds)
    if telemetry_spec is True:
        telemetry_spec = telemetry.TelemetrySpec(
            workload=batch.workload, rounds=r_total, traffic=True)
    tl = telemetry_spec is not None
    if tl and telemetry_spec.rounds < r_total:
        raise ValueError(
            f"serving telemetry ring must cover the horizon without "
            f"wrapping: rounds={telemetry_spec.rounds} < "
            f"r_total={r_total} (the per-cell freeze round indexes "
            "the unwrapped ring)")
    sig_fn = _serving_sig(telemetry_spec, r_total) if signatures else None
    n_whole = n_real
    if placed:
        b = len(batch.cells) // node_shards(mesh)
        clears = clears[node_index(mesh) * b:(node_index(mesh) + 1) * b]
        batch = dataclasses.replace(batch,
                                    cells=_block_of(batch.cells, mesh))
        n_real = len(batch.cells)
    sims, states, trackers, steps = [], [], [], []
    for c in batch.cells:
        sim, st = make_serving_sim(batch.workload, c.traffic, nemesis=c.spec,
                                   device=dev, **_serving_sim_kw(batch, c))
        sims.append(sim)
        states.append(st)
        trackers.append(sim.traffic_state(c.traffic))

        def step(st, tr, tel, sim=sim, tspec=c.traffic):
            if tel is None:
                st, tr = sim.run_traffic(st, tr, tspec, 1, donate=True)
                return st, tr, None
            return sim.run_traffic(st, tr, tspec, 1, donate=True, tel=tel,
                                   tel_spec=telemetry_spec)
        steps.append(step)
    tels = ([telemetry.init_state(telemetry_spec, dev) for _ in batch.cells]
            if tl else None)
    loop = serving_loop(steps, states, trackers, clears, batch.drain_every,
                        batch.max_recovery_rounds, r_total, tels)
    return {"loop": loop, "batch": batch, "n_real": n_real,
            "telemetry_spec": telemetry_spec, "sig_fn": sig_fn,
            "r_total": r_total, "placed": mesh if placed else None,
            "n_whole": n_whole}


def collect_serving_batch(handle: dict) -> dict:
    """Certify a run serving batch: per cell the latency summary, the
    sequential converged-round rule, the sequential ``check_recovery``
    verdict (open in-flight ops are lost acked writes) and conservation
    ANDed in.  Wall-clock fields are absent (one run serves the whole
    grid).  A scenario-placed grid's ranks' cells are gathered into the
    whole grid's (one gather, a collective call), fillers dropped."""
    res = _collect_serving_cells(handle)
    mesh = handle.get("placed")
    if mesh is None:
        return res
    res = _gather_blocks(res, mesh, "cells", "cell", "n_cells")
    n = handle["n_whole"]
    if n < res["n_cells"]:
        res["cells"] = res["cells"][:n]
        res["failing"] = [i for i in res["failing"] if i < n]
        res["ok"] = not res["failing"]
        res["n_cells"] = n
        for key in ("final", "trackers"):
            res[key] = _tree_map(lambda x: x[:n], res[key])
        if "telemetry" in res:
            res["telemetry"] = res["telemetry"][:n]
        if "signatures" in res:
            res["signatures"] = res["signatures"][:n]
    return res


def _collect_serving_cells(handle: dict) -> dict:
    """:func:`collect_serving_batch` over the cells this process ran."""
    from ..harness.checkers import check_recovery

    loop, batch = handle["loop"], handle["batch"]
    spec = handle["telemetry_spec"]
    n_real = handle["n_real"]
    cells = batch.cells[:n_real]
    max_rec = batch.max_recovery_rounds
    rows, failing = [], []
    for i, cell in enumerate(cells):
        ts = loop["trackers"][i]
        summ = traffic.latency_summary(ts)
        clear = cell.clear_round
        msgs = int(loop["states"][i].msgs)
        if summ["issued"] == 0:
            converged_round = clear
        elif summ["in_flight"] == 0:
            converged_round = max(clear, int(ts.done_round.max()))
        else:
            converged_round = None
        lost = ([{"open_ops": summ["in_flight"]}]
                if summ["in_flight"] else [])
        ok, det = check_recovery(
            clear_round=clear, converged_round=converged_round,
            max_recovery_rounds=max_rec, lost_writes=lost,
            msgs_at_clear=loop["msgs_clear"][i], msgs_at_converged=msgs,
            latency=summ)
        ok = ok and summ["conserved"]
        fr = loop["fr"][i]
        total_rounds = clear + (fr - clear if fr >= 0 else max_rec)
        det.update(
            workload=batch.workload, cell=i, coords=list(cell.coords),
            topology=cell.topology, n_nodes=batch.n_nodes,
            traffic=cell.traffic.to_meta(), **summ,
            offered_per_round=traffic.offered_per_round(cell.traffic),
            sustained_per_round=summ["completed"] / max(1, total_rounds),
            driven_rounds=cell.traffic.until, total_rounds=total_rounds,
            msgs_total=msgs, ok=ok)
        if cell.spec is not None:
            det["spec"] = cell.spec.to_meta()
        rows.append(det)
        if not ok:
            failing.append(i)
    res = {"ok": not failing, "workload": batch.workload,
           "n_cells": len(cells), "failing": failing, "cells": rows,
           "final": stack_pytrees(loop["states"][:n_real]),
           "trackers": stack_pytrees(loop["trackers"][:n_real]),
           "syncs": loop["syncs"], "trips": loop["trips"],
           "rounds": handle["r_total"]}
    if spec is not None:
        rings = [t.ring.cpu().numpy() for t in loop["tels"][:n_real]]
        wrote = [int(t.wrote) for t in loop["tels"][:n_real]]
        _tel_result(res, rings, wrote, spec)
    if handle["sig_fn"] is not None:
        sigs = np.stack([handle["sig_fn"](loop["trackers"][i], rings[i],
                                          wrote[i], loop["fr"][i],
                                          cell.clear_round)
                         for i, cell in enumerate(cells)])
        res["signatures"] = sigs
        for i, row in enumerate(rows):
            row["signature"] = [int(v) for v in sigs[i]]
    return res


def run_serving_batch(batch: ServingBatch, *, mesh=None,
                      telemetry_spec=None, signatures: bool = False,
                      n_windows: int | None = None,
                      n_burst: int | None = None, min_rounds: int = 0,
                      device=None) -> dict:
    """A whole (offered load x fault x topology) serving grid: per-cell
    p50 / p99 / max latency, sustained throughput, backpressure counts
    and ``check_recovery`` verdicts, each the sequential ``run_serving``
    row's.  ``signatures`` adds the per-cell (5,) signature (a ring
    covering the horizon: ``telemetry_spec=True``); ``n_windows`` /
    ``n_burst`` / ``min_rounds`` are the shape-bucket knobs."""
    return collect_serving_batch(dispatch_serving_batch(
        batch, mesh=mesh, telemetry_spec=telemetry_spec,
        signatures=signatures, n_windows=n_windows, n_burst=n_burst,
        min_rounds=min_rounds, device=device))


# -- state bytes and the program audit -----------------------------------


def batch_state_bytes(workload: str, s_local: int, n: int, *, nv: int = 0,
                      n_keys: int = 0, capacity: int = 0) -> int:
    """The state bytes of ``s_local`` scenarios of a batch: broadcast's
    two (N, W) bitsets, the counter's two (N,) rows, Kafka's presence,
    log, cells and committed cache (the reference's formula; the port's
    tensors have the same sizes)."""
    if workload == "broadcast":
        per = 2 * n * ((nv + 31) // 32) * 4
    elif workload == "counter":
        per = 2 * n * 4
    else:
        wc = (capacity + 31) // 32
        per = (n * n_keys * wc * 4 + n_keys * capacity * 4 + n_keys * 4
               + n * n_keys * 4)
    return s_local * per


def serving_state_bytes(workload: str, s_local: int, n: int,
                        n_clients: int, ops_per_client: int, *,
                        nv: int = 0, n_keys: int = 0,
                        capacity: int = 0) -> int:
    """:func:`batch_state_bytes` plus each cell's tracker: ``issued_k``
    (C,), the three (C, K) op tables and three scalar counters, 4 bytes
    each (the reference's formula)."""
    tracker = 4 * (n_clients + 3 * n_clients * ops_per_client + 3)
    return (batch_state_bytes(workload, s_local, n, nv=nv, n_keys=n_keys,
                              capacity=capacity) + s_local * tracker)


def audit_contracts():
    """The batch programs' contracts: ROADMAP.md Queue A item 14."""
    raise _unported("scenario.audit_contracts", 14)


def _audit_program(workload: str, batch, mesh, runner=None):
    """The batch program the contract auditor lowers: ROADMAP.md Queue A
    item 14."""
    raise _unported("scenario._audit_program", 14)
