"""Serving-frontier cartography and the coverage observatory on
PyTorch: the port of gossip_glomers_tpu/harness/frontier.py.

A (offered load x fault intensity x topology) grid of open-loop serving
runs is mapped in serving batches (:class:`..tpu_sim.scenario.
ServingBatch`, each cell on its own sim under its own plan, every row
equal to the sequential ``run_serving``), every cell is certified against
a falsifiable SLO (:func:`.checkers.check_slo`, problems naming grid
coordinates), and a failing cell writes a flight bundle that replays to
the same failure (:mod:`.observe`, ``kind="serving"``).

The coverage observatory rides the same dispatch: each cell's (5,)
behavioral signature (from its telemetry ring, ``scenario.signature_eval``)
lands in a host-side :class:`CoverageMap` that dedupes behaviors and
counts how many each fault-axis cell produced: the adaptive fuzzer's
signal (:func:`.fuzz.fuzz_run` ``adapt=True``).

:func:`frontier_table` flattens a report into table rows;
:func:`frontier_timeline` renders it as Perfetto tracks
(:class:`.observe.TimelineBuilder`); ``observe.validate_frontier`` checks
the report.  Pure host code; the runs go to ``device`` (CUDA unless
given), or with ``mesh=`` to a :class:`..parallel.mesh.Mesh` (every rank
calling), each rank running its block of every batch's cells
(:func:`..tpu_sim.scenario.dispatch_serving_batch`) and returning the
whole report, a failing cell's bundle written by rank 0.
"""

from __future__ import annotations

import time

import numpy as np

from ..tpu_sim import faults, traffic
from ..tpu_sim import scenario as SC

SIG_FIELDS = ("stall_bucket", "depth_bucket", "bp_class",
              "recovery_bucket", "churn_bucket")


def signature_key(sig) -> tuple:
    """Canonical hashable form of one (5,) behavioral signature."""
    arr = np.asarray(sig).reshape(-1)
    if arr.shape[0] != len(SIG_FIELDS):
        raise ValueError(
            f"signature has {arr.shape[0]} fields, expected "
            f"{len(SIG_FIELDS)} ({SIG_FIELDS})")
    return tuple(int(v) for v in arr)


class CoverageMap:
    """Host-side behavioral coverage over signature space: dedupes
    the (5,) signatures a campaign produced, remembers the first cell
    that exhibited each distinct behavior, and tracks per-AXIS-cell
    behavior counts (axis = the sampled fault-grid cell a scenario
    came from) — the adaptive fuzzer's steering signal.  Pure dict
    bookkeeping; JSON-able via :meth:`to_meta`."""

    def __init__(self) -> None:
        self._count: dict[tuple, int] = {}
        self._first: dict[tuple, dict] = {}
        self._axis: dict[tuple, set] = {}
        self._axis_seen: dict[tuple, int] = {}
        self.n_seen = 0

    def add(self, sig, *, axis=None, meta=None) -> bool:
        """Record one observed signature; returns True iff the
        BEHAVIOR is new (first time this exact signature appears)."""
        key = signature_key(sig)
        self.n_seen += 1
        new = key not in self._count
        self._count[key] = self._count.get(key, 0) + 1
        if new:
            self._first[key] = dict(meta or {})
        if axis is not None:
            axis = tuple(axis)
            self._axis.setdefault(axis, set()).add(key)
            self._axis_seen[axis] = self._axis_seen.get(axis, 0) + 1
        return new

    @property
    def n_distinct(self) -> int:
        return len(self._count)

    def axis_behaviors(self, axis) -> int:
        """How many DISTINCT behaviors this axis cell has produced so
        far (0 = never sampled — maximally interesting)."""
        return len(self._axis.get(tuple(axis), ()))

    def axis_samples(self, axis) -> int:
        return self._axis_seen.get(tuple(axis), 0)

    def novelty(self, axis) -> float:
        """The adaptive fuzzer's steering score for one fault-axis
        cell: an UNSAMPLED axis scores 2.0 (strictly above every
        sampled one — breadth over the fault grid first), a sampled
        axis scores behaviors-per-sample (<= 1.0): it stays warm
        while every sample keeps yielding a new behavior and decays
        toward 0 once exhausted."""
        axis = tuple(axis)
        seen = self._axis_seen.get(axis, 0)
        if seen == 0:
            return 2.0
        return len(self._axis.get(axis, ())) / seen

    def count(self, sig) -> int:
        return self._count.get(signature_key(sig), 0)

    def heatmap(self) -> list[dict]:
        """(stall_bucket, bp_class) -> {n_behaviors, n_seen} rows —
        the 2-D projection the coverage heatmap track renders."""
        cells: dict[tuple, list] = {}
        for key, c in self._count.items():
            cur = cells.setdefault((key[0], key[2]), [0, 0])
            cur[0] += 1
            cur[1] += c
        return [{"stall_bucket": s, "bp_class": b,
                 "n_behaviors": v[0], "n_seen": v[1]}
                for (s, b), v in sorted(cells.items())]

    def to_meta(self) -> dict:
        return {
            "n_distinct": self.n_distinct,
            "n_seen": self.n_seen,
            "fields": list(SIG_FIELDS),
            "signatures": [
                {"signature": list(k), "count": self._count[k],
                 "first": self._first[k]}
                for k in sorted(self._count)],
            "axes": [
                {"axis": list(a),
                 "n_behaviors": len(self._axis[a]),
                 "n_samples": self._axis_seen.get(a, 0)}
                for a in sorted(self._axis)],
            "heatmap": self.heatmap(),
        }

    @staticmethod
    def from_meta(meta: dict) -> "CoverageMap":
        cm = CoverageMap()
        for row in meta.get("signatures", ()):
            for _ in range(int(row["count"])):
                cm.add(row["signature"], meta=row.get("first"))
        return cm


# -- grid staging --------------------------------------------------------


def _fault_level_spec(level, n_nodes: int, horizon: int,
                      seed: int):
    """Resolve one fault-axis level to a NemesisSpec | None: None /
    a ready spec pass through; a dict is ``faults.random_spec``
    kwargs (n_crash_windows / loss_rate / dup_rate) seeded per grid
    row so equal levels at different coordinates draw distinct
    windows."""
    if level is None or isinstance(level, faults.NemesisSpec):
        return level
    if isinstance(level, dict):
        kw = dict(level)
        if not (kw.get("n_crash_windows") or kw.get("loss_rate")
                or kw.get("dup_rate")):
            return None
        return faults.random_spec(
            n_nodes, seed=seed, horizon=horizon,
            n_crash_windows=int(kw.get("n_crash_windows", 0)),
            loss_rate=float(kw.get("loss_rate", 0.0)),
            dup_rate=float(kw.get("dup_rate", 0.0)))
    raise ValueError(f"unknown fault level {level!r}")


def frontier_grid(workload: str, *, n_nodes: int, rates,
                  fault_levels, topologies=("grid",),
                  n_clients: int | None = None,
                  ops_per_client: int = 2, until: int = 10,
                  kind: str = "poisson", seed: int = 0,
                  ) -> list[SC.ServingCell]:
    """The full (rate x fault level x topology) cross product as
    :class:`~..tpu_sim.scenario.ServingCell`s with ``coords =
    (i_rate, i_fault, i_topo)`` — len(rates) * len(fault_levels) *
    len(topologies) cells, each with a distinct traffic seed (the
    cells are distinct open-loop runs, not one run re-observed).
    Counter/kafka ignore the topology axis; pass the default 1-tuple
    there."""
    n_clients = n_clients or n_nodes
    cells = []
    for ir, rate in enumerate(rates):
        for jf, level in enumerate(fault_levels):
            for kt, topo in enumerate(topologies):
                idx = (ir * len(fault_levels) + jf) \
                    * len(topologies) + kt
                spec = _fault_level_spec(
                    level, n_nodes, until, seed * 100003 + idx + 1)
                cells.append(SC.ServingCell(
                    traffic=traffic.TrafficSpec(
                        n_nodes=n_nodes, n_clients=n_clients,
                        ops_per_client=ops_per_client, until=until,
                        rate=float(rate), kind=kind,
                        seed=seed * 7919 + idx),
                    spec=spec, topology=topo,
                    coords=(ir, jf, kt)))
    return cells


def _chunk_cells(cells, batch_size: int | None):
    if not batch_size or batch_size >= len(cells):
        return [list(cells)]
    return [list(cells[i:i + batch_size])
            for i in range(0, len(cells), batch_size)]


# -- SLO signatures (the serving shrinker's identity) --------------------


def slo_signature(row: dict, slo: dict) -> dict | None:
    """What makes two SLO failures "the same" for the serving
    shrinker (harness/fuzz.py ``shrink_serving_cell``): WHICH bounds
    broke (not their exact values — a shrunk cell keeps the same
    violation classes) plus whether the cell ever drained.  None for
    a passing cell."""
    from .checkers import check_slo

    ok, det = check_slo(row, **slo)
    if ok:
        return None
    kinds = []
    for p in det["problems"]:
        body = p.split(": ", 1)[-1]
        kinds.append(body.split()[0])
    return {"workload": row.get("workload"),
            "converged": row.get("converged_round") is not None,
            "kinds": tuple(sorted(set(kinds)))}


# -- the frontier runner -------------------------------------------------


def _cell_bundle(out_dir: str, workload: str, cell, row: dict,
                 verdict: dict, runner_kw: dict,
                 max_recovery_rounds: int, drain_every: int,
                 telemetry_series=None,
                 telemetry_spec=None, mesh=None) -> str:
    """One failing grid cell's flight bundle: the full TrafficSpec +
    NemesisSpec + grid coordinates + the SLO verdict, replayable by
    ``observe.replay_bundle`` (kind="serving") to the same failure (on a
    ``mesh`` written once, by rank 0)."""
    from . import observe

    sim_kw = dict(runner_kw)
    if workload == "broadcast":
        sim_kw["topology"] = cell.topology
    return observe.write_bundle_on_mesh(
        mesh, out_dir, kind="serving", workload=workload,
        nemesis=(None if cell.spec is None else cell.spec.to_meta()),
        traffic=cell.traffic.to_meta(),
        sim_kw=sim_kw,
        runner_kw={"max_recovery_rounds": max_recovery_rounds,
                   "drain_every": drain_every},
        telemetry_spec=(telemetry_spec.to_meta()
                        if telemetry_spec is not None else None),
        telemetry_series=telemetry_series,
        failure={"checker": "check_slo",
                 "grid_coords": list(cell.coords),
                 "cell": row.get("cell"),
                 "signature": row.get("signature"),
                 "slo": verdict.get("slo"),
                 "problems": verdict["problems"]})


def run_frontier(workload: str, cells, *, mesh=None,
                 runner_kw: dict | None = None,
                 slo: dict | None = None,
                 batch_size: int | None = None,
                 max_recovery_rounds: int = 96,
                 drain_every: int = 8,
                 signatures: bool = True,
                 pipeline: bool = True,
                 coverage: CoverageMap | None = None,
                 observe_dir: str | None = None,
                 n_windows: int | None = None,
                 n_burst: int | None = None,
                 device=None) -> dict:
    """Map + certify a serving frontier: chunk ``cells`` into
    :class:`~..tpu_sim.scenario.ServingBatch`es, dispatch each
    (pipelined to depth 2 when ``pipeline``: batch i+1 is dispatched
    before batch i is collected, with no host sync between them), run
    every
    row through the falsifiable ``checkers.check_slo`` (problems name
    grid coordinates), fold each cell's behavioral signature into the
    ``coverage`` map, and write a replayable flight bundle per
    failing cell when ``observe_dir`` is given.

    ``slo`` is the check_slo kwargs dict (e.g. ``{"p99_max_rounds":
    12, "min_completed": 1}``); None certifies only the serving
    invariants the batch itself carries (drain + conservation).
    Returns the frontier report (``observe.validate_frontier``).  The
    batches run on ``device`` (CUDA unless given), or on ``mesh`` (module
    docstring: every rank calls and gets the same report)."""
    from ..tpu_sim.engine import check_mesh
    from .checkers import check_frontier_batch

    check_mesh(mesh)
    cells = list(cells)
    if not cells:
        raise ValueError("run_frontier needs at least one cell")
    kw = dict(runner_kw or {})
    slo = dict(slo or {})
    coverage = coverage if coverage is not None else CoverageMap()
    chunks = _chunk_cells(cells, batch_size)
    batches = [SC.ServingBatch(
        workload=workload, cells=tuple(ch), runner_kw=kw,
        max_recovery_rounds=max_recovery_rounds,
        drain_every=drain_every) for ch in chunks]

    t0 = time.perf_counter()
    walls: list[float] = []
    results: list[dict | None] = [None] * len(batches)
    specs: list = [None] * len(batches)

    def dispatch(b):
        return SC.dispatch_serving_batch(
            batches[b], mesh=mesh,
            telemetry_spec=(True if signatures else None),
            signatures=signatures, n_windows=n_windows,
            n_burst=n_burst, device=device)

    def collect(b, handle):
        specs[b] = handle["telemetry_spec"]
        results[b] = SC.collect_serving_batch(handle)

    if pipeline:
        # depth 2: batch b is dispatched before batch b-1 is collected;
        # the verdicts equal the unpipelined path's, only the wall moves
        pending = None
        for b in range(len(batches)):
            tb = time.perf_counter()
            h = dispatch(b)
            if pending is not None:
                collect(b - 1, pending)
                walls.append(round(time.perf_counter() - tb, 3))
            pending = h
        tb = time.perf_counter()
        collect(len(batches) - 1, pending)
        walls.append(round(time.perf_counter() - tb, 3))
    else:
        for b in range(len(batches)):
            tb = time.perf_counter()
            collect(b, dispatch(b))
            walls.append(round(time.perf_counter() - tb, 3))
    dispatch_s = time.perf_counter() - t0

    rows: list[dict] = []
    tel_rows: list = []
    tel_specs: list = []
    for b, res in enumerate(results):
        for i, row in enumerate(res["cells"]):
            row = dict(row)
            row["batch"] = b
            # global surface index — batch-local ids would make the
            # report (and coverage map) depend on execution layout
            row["cell"] = len(rows)
            rows.append(row)
        tel_rows.extend(res.get("telemetry")
                        or [None] * len(res["cells"]))
        tel_specs.extend([specs[b]] * len(res["cells"]))
    serving_ok = [bool(r["ok"]) for r in rows]
    slo_ok, slo_det = check_frontier_batch(rows, slo)

    if signatures:
        for row in rows:
            sig = row.get("signature")
            if sig is None:
                raise AssertionError(
                    "signatures=True but a frontier row has none — "
                    "the batch dispatcher is pinned to emit them")
            coverage.add(sig, axis=row.get("coords"),
                         meta={"coords": row.get("coords"),
                               "cell": row.get("cell")})

    bundles: list[dict] = []
    flat_cells = [c for ch in chunks for c in ch]
    failing = sorted(set(slo_det["failing"])
                     | {i for i, ok in enumerate(serving_ok)
                        if not ok})
    if observe_dir:
        for i in failing:
            verdict = slo_det["cells"][i]
            if verdict["ok"]:   # serving-invariant failure only
                verdict = {"problems": [
                    f"cell{tuple(flat_cells[i].coords)!r}: serving "
                    "certifier failed (drain/conservation)"]}
            verdict = dict(verdict)
            verdict["slo"] = slo
            path = _cell_bundle(
                observe_dir, workload, flat_cells[i], rows[i],
                verdict, kw, max_recovery_rounds, drain_every,
                telemetry_series=tel_rows[i],
                telemetry_spec=tel_specs[i], mesh=mesh)
            bundles.append({"cell": i,
                            "coords": list(flat_cells[i].coords),
                            "path": path})

    report = {
        "schema": "gg-frontier/1",
        "workload": workload,
        "ok": bool(slo_ok) and all(serving_ok),
        "n_cells": len(rows),
        "n_batches": len(batches),
        "batch_sizes": [len(ch) for ch in chunks],
        "pipelined": bool(pipeline),
        "slo": slo,
        "slo_ok": bool(slo_ok),
        "serving_ok": all(serving_ok),
        "failing": failing,
        "problems": slo_det["problems"],
        "cells": [
            {**{k: v for k, v in row.items()
                if k not in ("signature",)},
             "slo_ok": slo_det["cells"][i]["ok"],
             "slo_problems": slo_det["cells"][i]["problems"],
             **({"signature": row["signature"]}
                if "signature" in row else {})}
            for i, row in enumerate(rows)],
        "coverage": coverage.to_meta() if signatures else None,
        "bundles": bundles,
        "dispatch_s": round(dispatch_s, 3),
        "batch_walls_s": walls,
        "cells_per_sec": round(len(rows) / max(1e-9, dispatch_s), 2),
    }
    return report


# -- artifacts -----------------------------------------------------------


def frontier_table(report: dict, keys=("lat_p50", "lat_p99",
                                       "lat_max",
                                       "sustained_per_round",
                                       "completed", "in_flight",
                                       "recovery_rounds")) -> list:
    """Flatten one frontier report into table rows: one compact dict per
    grid cell — coordinates, the SLO surface
    metrics, the verdicts, the behavioral signature."""
    rows = []
    for cell in report["cells"]:
        row = {"coords": cell.get("coords"),
               "ok": cell.get("ok"),
               "slo_ok": cell.get("slo_ok")}
        for k in keys:
            row[k] = cell.get(k)
        if "signature" in cell:
            row["signature"] = cell["signature"]
        rows.append(row)
    return rows


def frontier_timeline(report: dict, *, name: str | None = None,
                      metric: str = "lat_p99") -> dict:
    """Render a frontier report through the Perfetto serializer:
    one ``frontier`` slice per grid cell (1 cell = 1 ms of trace
    time, coordinates + verdict in args, failing cells on their own
    ``slo violations`` track), the SLO surface as counter tracks
    (p99/sustained per cell index), and the coverage observatory as
    cumulative-distinct-behaviors + per-heatmap-cell counters.  Loads
    at ui.perfetto.dev; schema-checked by
    ``observe.validate_timeline``."""
    from .observe import US_PER_ROUND, TimelineBuilder

    u = US_PER_ROUND
    tb = TimelineBuilder(name or f"{report['workload']} frontier")
    seen: set = set()
    distinct = 0
    for i, cell in enumerate(report["cells"]):
        coords = tuple(cell.get("coords") or ())
        label = f"cell{coords!r}" if coords else f"cell {i}"
        ok = bool(cell.get("ok")) and bool(cell.get("slo_ok", True))
        tb.slice("frontier", label, i * u, u,
                 args={"coords": list(coords), "ok": ok,
                       "lat_p99": cell.get("lat_p99"),
                       "sustained": cell.get(
                           "sustained_per_round")})
        if not ok:
            tb.slice("slo violations", label, i * u, u,
                     args={"problems": cell.get("slo_problems",
                                                [])[:4]})
        if cell.get(metric) is not None:
            tb.counter("frontier", metric, i * u,
                       int(round(cell[metric])))
        if cell.get("sustained_per_round") is not None:
            tb.counter("frontier", "sustained_milli", i * u,
                       int(round(1000
                                 * cell["sustained_per_round"])))
        sig = cell.get("signature")
        if sig is not None:
            key = signature_key(sig)
            if key not in seen:
                seen.add(key)
                distinct += 1
            tb.counter("coverage", "distinct_behaviors", i * u,
                       distinct)
    for row in (report.get("coverage") or {}).get("heatmap", ()):
        tb.counter(
            "coverage",
            f"stall{row['stall_bucket']}_bp{row['bp_class']}",
            (len(report["cells"]) - 1) * u, row["n_seen"])
    return tb.to_dict()
