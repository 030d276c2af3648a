"""Serving runner on PyTorch: the port of
gossip_glomers_tpu/harness/serving.py — certified open-loop serving runs
over the traffic engine (:mod:`..tpu_sim.traffic`) and latency-vs-offered
-load curves.

``run_serving`` drives one run: build the sim (optionally under a seeded
crash / loss :class:`..tpu_sim.faults.NemesisSpec`, which the sim's
traffic driver composes with the arrivals), run the driven phase
(``spec.until`` rounds of arrivals), let any fault horizon clear, then
drain: keep running arrival-free rounds until every issued op is
globally visible or the budget runs out.  The verdict is
:func:`.checkers.check_recovery` over the tracker — a bounded drain and
zero lost acknowledged ops (an op still in flight after the drain) —
with the op latencies p50 / p99 / max in rounds beside it.
``run_serving_curve`` sweeps the offered load (the per-client rate) and
returns one row per load.

Runs go on ``device`` (CUDA unless given).  A failed run writes its
flight bundle into ``observe_dir`` (:func:`.observe.write_flight_bundle`);
with ``GG_PROFILE_DIR`` set, the driven phase runs under
:func:`.observe.profiled` and leaves a ``torch.profiler`` Chrome trace
there.

``mesh=`` (a :class:`..parallel.mesh.Mesh`, every rank calling) builds
the sim on the mesh (the structured bundles with their halo closures,
``n_shards`` the rank count; a structured topology's own halo exchange)
and runs the same certified run on its device: the drain test, the
tracker's report and the series are collective reads that every rank
gets whole, a failed run's bundle is written by rank 0, and the result's
``mesh`` is the rank count.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..parallel.topology import grid, to_padded_neighbors, tree
from ..tpu_sim import structured as S
from ..tpu_sim import telemetry as TM
from ..tpu_sim import traffic
from ..tpu_sim.broadcast import BroadcastSim
from ..tpu_sim.counter import CounterSim
from ..tpu_sim.engine import check_mesh, node_shards, resolve_device
from ..tpu_sim.faults import NemesisSpec
from ..tpu_sim.kafka import KafkaSim
from . import observe
from .checkers import check_op_latency, check_recovery, check_telemetry
from .observe import telemetry_setup

_TOPOLOGIES = {"grid": grid, "tree": tree}


def serving_widths(kind: str, tspec: "traffic.TrafficSpec",
                   sim_kw: dict) -> dict:
    """The widths :func:`make_serving_sim` gives ``kind``'s sim for
    ``tspec`` where ``sim_kw`` names none: broadcast ``n_values`` (every
    op its own value bit); kafka ``n_keys`` and ``capacity`` (~2x the
    expected per-key op volume, so the fault-free curve measures
    latency, not capacity backpressure); none for the counter."""
    if kind == "broadcast":
        return dict(n_values=sim_kw.get(
            "n_values", tspec.n_clients * tspec.ops_per_client))
    if kind == "kafka":
        expect = tspec.rate * tspec.n_clients * tspec.until
        n_keys = sim_kw.get("n_keys", 16)
        return dict(n_keys=n_keys, capacity=sim_kw.get(
            "capacity", max(64, int(2 * expect / n_keys + 32))))
    return {}


def make_serving_sim(kind: str, tspec: "traffic.TrafficSpec", *,
                     nemesis: NemesisSpec | None = None, mesh=None,
                     device: str | torch.device | None = None, **sim_kw):
    """Build the sim a serving run drives, and its empty state, on
    ``device``.  ``sim_kw`` (per kind): broadcast — ``topology`` ("grid"
    / "tree"), ``structured`` (the words-major path), ``sync_every``,
    ``n_values``, ``dir_delays`` / ``edge_delay_rows`` (structured delay
    modes), ``delays`` (gather per-edge delays); counter — ``mode``,
    ``poll_every``, ``union_block``; kafka — ``n_keys``, ``capacity``,
    ``max_sends``, ``resync_every``, ``resync_mode``, ``union_block``.
    ``mesh``: build it on the mesh (its device is the sim's; the
    structured bundles get ``n_shards``, the structured exchange its halo
    form)."""
    check_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    n_sh = None if mesh is None else node_shards(mesh)
    place = dict(device=dev) if mesh is None else dict(mesh=mesh)
    n = tspec.n_nodes
    if nemesis is not None and nemesis.n_nodes != n:
        raise ValueError(
            f"NemesisSpec is for {nemesis.n_nodes} nodes, traffic "
            f"for {n}")
    plan = nemesis.compile(device=dev) if nemesis is not None else None
    sim_kw.update(serving_widths(kind, tspec, sim_kw))

    if kind == "broadcast":
        topology = sim_kw.pop("topology", "grid")
        structured = bool(sim_kw.pop("structured", False))
        sync_every = sim_kw.pop("sync_every", 4)
        n_values = sim_kw.pop("n_values")
        dir_delays = sim_kw.pop("dir_delays", None)
        edge_delay_rows = sim_kw.pop("edge_delay_rows", None)
        if sim_kw.get("delays") is not None:
            sim_kw["delays"] = np.asarray(sim_kw["delays"], np.int32)
        if (dir_delays is not None or edge_delay_rows is not None) \
                and not structured:
            raise ValueError(
                "dir_delays/edge_delay_rows are words-major "
                "structured modes: pass structured=True (per-edge "
                "gather delays ride run_broadcast_nemesis(delays=))")
        kw = dict(sync_every=sync_every, srv_ledger=False,
                  fault_plan=plan, **place, **sim_kw)
        if structured:
            kw["exchange"] = S.make_exchange(topology, n)
            if edge_delay_rows is not None:
                if nemesis is not None:
                    raise ValueError(
                        "edge-delayed structured serving has no "
                        "FaultPlan composition (partition windows "
                        "compose via make_edge_delayed_faulted); "
                        "use dir_delays= for a faulted delayed run")
                kw["edge_delayed"] = S.make_edge_delayed(
                    topology, n, np.asarray(edge_delay_rows, np.int32),
                    n_shards=n_sh)
            elif nemesis is not None:
                kw["nemesis"] = S.make_nemesis(
                    topology, n, nemesis, device=dev, n_shards=n_sh,
                    dir_delays=(None if dir_delays is None
                                else tuple(dir_delays)))
            elif dir_delays is not None:
                kw["delayed"] = S.make_delayed(topology, n,
                                               tuple(dir_delays),
                                               n_shards=n_sh)
            elif n_sh is not None:
                kw["sharded_exchange"] = S.make_sharded_exchange(
                    topology, n, n_sh)
        try:
            build = _TOPOLOGIES[topology]
        except KeyError:
            raise ValueError(
                f"unknown topology {topology!r}; "
                f"one of {sorted(_TOPOLOGIES)}") from None
        sim = BroadcastSim(to_padded_neighbors(build(n)),
                           n_values=n_values, **kw)
    elif kind == "counter":
        sim = CounterSim(n, mode=sim_kw.pop("mode", "cas"),
                         poll_every=sim_kw.pop("poll_every", 2),
                         fault_plan=plan, **place, **sim_kw)
    elif kind == "kafka":
        sim = KafkaSim(n, sim_kw.pop("n_keys"),
                       capacity=sim_kw.pop("capacity"),
                       max_sends=sim_kw.pop("max_sends", 4),
                       fault_plan=plan,
                       resync_every=sim_kw.pop("resync_every", 4),
                       **place, **sim_kw)
    else:
        raise ValueError(f"unknown serving workload {kind!r}")
    return sim, _fresh_state(kind, sim)


def _fresh_state(kind: str, sim):
    if kind == "broadcast":
        return sim.init_state(
            np.zeros((sim.n_nodes, sim.n_words), np.uint32))
    return sim.init_state()


def _issued(ts, mesh=None) -> int:
    """The ops issued (over every rank of a ``mesh``: a collective)."""
    n = ts.issued_k.sum(dtype=torch.int64)
    return int(n if mesh is None else mesh.all_reduce(n, "sum"))


def run_serving(kind: str, tspec: "traffic.TrafficSpec", *,
                nemesis: NemesisSpec | None = None, mesh=None,
                sim_kw: dict | None = None,
                max_recovery_rounds: int = 96,
                drain_every: int = 8,
                series: bool = False, sim=None,
                telemetry=None, observe_dir=None,
                latency_bound: dict | None = None,
                device: str | torch.device | None = None) -> dict:
    """One open-loop serving run, certified (module docstring); the
    reference's arguments and result.  Returns the merged
    ``check_recovery`` details: ``ok`` (bounded drain, zero lost acked
    ops, conservation), the tracker summary, offered and sustained load
    and, with ``series``, the per-round issue / completion counts.
    ``sim``: a prebuilt sim to reuse (the curve sweep passes one).
    ``telemetry`` (None: the ``GG_TELEMETRY`` switch / True / False / a
    ``TelemetrySpec(traffic=True)``) records the ring through every
    phase and cross-checks it (``check_telemetry``); ``latency_bound``
    (``check_op_latency`` kwargs) ANDs a latency bound into the verdict.
    ``device``: where a sim built here runs (CUDA unless given).
    ``observe_dir``: where a failed run writes its flight bundle.
    ``mesh``: run on the mesh (module docstring; ``sim``, when given,
    must be on it)."""
    if sim is not None:
        mesh = sim.mesh
    if nemesis is not None and nemesis.has_membership:
        raise ValueError(
            "serving runs do not support membership events yet: the "
            "open-loop traffic tracker has no join/leave-aware intake "
            "gating, so a membership-bearing nemesis would issue ops "
            "to non-member rows — run join/leave campaigns on the "
            "closed-loop nemesis runners (harness.nemesis) or the "
            "scenario batch path instead")
    if sim is None:
        sim, state = make_serving_sim(kind, tspec, nemesis=nemesis,
                                      mesh=mesh, device=device,
                                      **(sim_kw or {}))
    else:
        state = _fresh_state(kind, sim)
    ts = sim.traffic_state(tspec)
    clear = max(tspec.until,
                nemesis.clear_round if nemesis is not None else 0)
    tel_spec = telemetry_setup(telemetry, kind, clear + max_recovery_rounds,
                               True)
    tel = (TM.init_state(tel_spec, device=sim.device)
           if tel_spec is not None else None)

    def drive(st, tr, tl, n):
        if tl is None:
            st, tr = sim.run_traffic(st, tr, tspec, n, donate=True)
            return st, tr, None
        return sim.run_traffic(st, tr, tspec, n, donate=True,
                               tel=tl, tel_spec=tel_spec)

    def sync():
        if sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)

    t0 = time.perf_counter()
    # the optional profiler capture around the driven phase (a no-op
    # unless GG_PROFILE_DIR is set)
    with observe.profiled(os.environ.get("GG_PROFILE_DIR") or None):
        state, ts, tel = drive(state, ts, tel, tspec.until)
        sync()
    driven_s = time.perf_counter() - t0
    if clear > tspec.until:
        # faults outlast the traffic horizon: keep the system running
        # (no arrivals past `until`) until the plan clears
        state, ts, tel = drive(state, ts, tel, clear - tspec.until)
    msgs_at_clear = int(state.msgs)
    drained = 0
    while (int(ts.completed) < _issued(ts, mesh)
           and drained < max_recovery_rounds):
        step = min(drain_every, max_recovery_rounds - drained)
        state, ts, tel = drive(state, ts, tel, step)
        drained += step
    sync()
    total_s = time.perf_counter() - t0
    summ = traffic.latency_summary(ts, mesh)
    if summ["issued"] == 0:
        converged_round = clear
    elif summ["in_flight"] == 0:
        last = ts.done_round.max().to(torch.int64)
        if mesh is not None:
            last = mesh.all_reduce(last, "max")
        converged_round = max(clear, int(last))
    else:
        converged_round = None
    lost = ([{"open_ops": summ["in_flight"]}]
            if summ["in_flight"] else [])
    ok, details = check_recovery(
        clear_round=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost_writes=lost,
        msgs_at_clear=msgs_at_clear, msgs_at_converged=int(state.msgs),
        latency=summ)
    ok = ok and summ["conserved"]
    if latency_bound is not None:
        ok_lat, lat_details = check_op_latency(summ, **latency_bound)
        ok = ok and ok_lat
        details["latency_bound"] = {"kw": latency_bound,
                                    **lat_details}
    total_rounds = clear + drained
    details.update(
        workload=kind, n_nodes=tspec.n_nodes,
        mesh=None if mesh is None else node_shards(mesh),
        traffic=tspec.to_meta(), **summ,
        offered_per_round=traffic.offered_per_round(tspec),
        sustained_per_round=summ["completed"] / max(1, total_rounds),
        ops_per_sec=summ["completed"] / max(1e-9, total_s),
        driven_rounds=tspec.until, total_rounds=total_rounds,
        driven_s=round(driven_s, 4), total_s=round(total_s, 4),
        msgs_total=int(state.msgs))
    if nemesis is not None:
        details["spec"] = nemesis.to_meta()
    if series or nemesis is not None:
        sr = traffic.per_round_series(ts, total_rounds, mesh)
        if series:
            details.update(sr)
        if nemesis is not None and nemesis.crash:
            # the serving cliff: completions a round inside the fault
            # window against after it clears
            comp = np.asarray(sr["completed_by_round"], np.float64)
            f_lo = min(s for s, _e, _n in nemesis.crash)
            faulted = comp[f_lo:clear]
            after = comp[clear:]
            details["cliff"] = {
                "fault_window": [f_lo, clear],
                "faulted_completions_per_round": (
                    float(faulted.mean()) if faulted.size else None),
                "recovery_completions_per_round": (
                    float(after.mean()) if after.size else None),
            }
    tel_series = tel_meta = None
    if tel is not None:
        tel_series = TM.series_arrays(tel, tel_spec)
        ok_t, t_det = check_telemetry(
            tel_series, msgs_total=int(state.msgs), traffic=summ)
        details["telemetry"] = {"spec": tel_spec.to_meta(),
                                "series": tel_series, "check": t_det}
        tel_meta = tel_spec.to_meta()
        ok = ok and ok_t
    if not ok and observe_dir is not None:
        failure = {k: details[k] for k in
                   ("recovery_rounds", "n_lost_writes", "lost_writes",
                    "conserved", "latency_bound")
                   if k in details}
        details["flight_bundle"] = observe.write_bundle_on_mesh(
            mesh, observe_dir, kind="serving", workload=kind,
            nemesis=(nemesis.to_meta() if nemesis is not None
                     else None),
            traffic=tspec.to_meta(), sim_kw=sim_kw or {},
            runner_kw=dict(max_recovery_rounds=max_recovery_rounds,
                           drain_every=drain_every,
                           latency_bound=latency_bound),
            telemetry_spec=tel_meta, telemetry_series=tel_series,
            failure=failure)
    return {"ok": ok, **details}


def run_serving_curve(kind: str, tspec: "traffic.TrafficSpec",
                      loads, *, nemesis: NemesisSpec | None = None,
                      mesh=None, sim_kw: dict | None = None,
                      device: str | torch.device | None = None,
                      **kw) -> list:
    """Latency-vs-offered-load table: one :func:`run_serving` row per
    per-client ``rate`` in ``loads`` (same seed and shape).  Builds the
    sim once (capacity defaults sized at the heaviest load) and reuses
    it (on ``mesh``, when given: every rank calls)."""
    sim, _ = make_serving_sim(kind, tspec.with_rate(float(max(loads))),
                              nemesis=nemesis, mesh=mesh, device=device,
                              **dict(sim_kw or {}))
    return [run_serving(kind, tspec.with_rate(float(r)),
                        nemesis=nemesis, sim_kw=sim_kw, sim=sim, **kw)
            for r in loads]
