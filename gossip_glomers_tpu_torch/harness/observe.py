"""Run observation on the host: the port of
gossip_glomers_tpu/harness/observe.py — run manifests, Perfetto
timelines, the flight recorder, and the causal layer over the provenance
record.

- :func:`telemetry_setup` / :func:`provenance_setup`: a runner's
  argument (None: the ``GG_TELEMETRY`` / ``GG_PROVENANCE`` switch; True /
  False; a spec) to a spec or None.
- :class:`TimelineBuilder` and :func:`run_timeline`: a finished run's
  Chrome-trace (Perfetto) timeline, rounds as slices (1 round = 1 ms of
  trace time), fault windows and traffic phases as tracks, each
  telemetry series a counter track, and with :func:`add_provenance_flows`
  a broadcast record's dissemination trees as flow arrows;
  :func:`validate_timeline` checks one loudly.
- :func:`run_manifest` / :func:`validate_manifest`: the reproducibility
  record of a run (its config, specs, verdict and timings; ``env`` from
  torch: version, backend, device count and name; ``programs`` as the
  caller gives them, since PyTorch has no compiled-program fingerprint).
- :func:`write_flight_bundle`: on a checker failure, one atomically
  written JSON file (:func:`write_json_atomic`) with the seeds, the
  fault, traffic and telemetry specs, the recorded series and stamps and
  the failing checker's details; :func:`replay_bundle` re-runs the
  campaign from the bundle alone (on ``device``) and reports the first
  round at which its re-recorded series or stamps diverge
  (:func:`replay_divergence`; None for a faithful replay).  The schema
  strings are the reference's, so a bundle written by either package
  loads and replays in the other.
- :func:`dissemination_tree` / :func:`validate_tree`: per-value spanning
  trees, the critical path and the busiest edges of a broadcast record
  (:func:`..tpu_sim.provenance.arrays_of`), as JSON-able data.
- :func:`profiled`: an optional ``torch.profiler`` capture that exports a
  Chrome trace (the serving runner's ``GG_PROFILE_DIR``).
- :func:`validate_frontier`: the frontier report's schema check
  (:mod:`.frontier`).

Pure host code over numpy; tests/test_torch_observe.py and
test_torch_provenance.py hold each function equal to the reference's.
Not ported yet, and raising: ``replay_bundle(mesh=)`` (ROADMAP.md Queue A
item 10).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..tpu_sim import provenance as PV
from ..tpu_sim import telemetry as TM

US_PER_ROUND = 1000.0     # 1 round = 1 ms of trace time
_MAX_ROUND_SLICES = 4096  # timeline cap; longer runs keep counters only
_MAX_FLOW_VALUES = 8      # flow arrows drawn for at most this many values

MANIFEST_SCHEMA = "gg-run-manifest/1"
TIMELINE_SCHEMA = "gg-timeline/1"
BUNDLE_SCHEMA = "gg-flight-bundle/1"
TREE_SCHEMA = "gg-dissemination-tree/1"
FRONTIER_SCHEMA = "gg-frontier/1"


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md Queue A item {item})")


# -- runner-side telemetry resolution ------------------------------------


def telemetry_setup(telemetry, workload: str, rounds: int,
                    traffic: bool = False):
    """Resolve a runner's ``telemetry=`` to a :class:`..tpu_sim.telemetry.
    TelemetrySpec` or None: None consults ``GG_TELEMETRY`` (off unless
    1); True / False force the default spec (``GG_TELEMETRY_SERIES``-
    filtered, ring sized to ``rounds``) or off; a spec is used as it is,
    once its workload and traffic flag match."""
    if telemetry is None:
        telemetry = TM.enabled()
    if telemetry is False:
        return None
    if telemetry is True:
        return TM.default_spec(workload, rounds, traffic)
    spec = telemetry
    if spec.workload != workload or spec.traffic != traffic:
        raise ValueError(
            f"TelemetrySpec(workload={spec.workload!r}, "
            f"traffic={spec.traffic}) does not match this run "
            f"(workload={workload!r}, traffic={traffic})")
    return spec


def provenance_setup(provenance, workload: str):
    """Resolve a runner's ``provenance=`` to a :class:`..tpu_sim.provenance.
    ProvenanceSpec` or None, as :func:`telemetry_setup` does: None
    consults ``GG_PROVENANCE`` (default off), True / False force, a spec
    is used as it is once its workload matches."""
    if provenance is None:
        provenance = PV.enabled()
    if provenance is False:
        return None
    if provenance is True:
        return PV.default_spec(workload)
    spec = provenance
    if spec.workload != workload:
        raise ValueError(
            f"ProvenanceSpec(workload={spec.workload!r}) does not "
            f"match this run (workload={workload!r})")
    return spec


# -- the shared Perfetto serializer --------------------------------------


class TimelineBuilder:
    """Chrome-trace (Perfetto-loadable) event builder, the reference's
    serializer (its telemetry timelines and its virtual-harness trace
    export render through it).  Times are microseconds."""

    def __init__(self, name: str = "run") -> None:
        self.name = name
        self.events: list[dict] = []
        self._tids: dict[str, int] = {}
        self._flow_id = 0
        self.events.append({"ph": "M", "pid": 1, "tid": 0,
                            "name": "process_name",
                            "args": {"name": name}})

    def _tid(self, track: str) -> int:
        if track not in self._tids:
            tid = len(self._tids) + 1
            self._tids[track] = tid
            self.events.append({"ph": "M", "pid": 1, "tid": tid,
                                "name": "thread_name",
                                "args": {"name": track}})
        return self._tids[track]

    def slice(self, track: str, name: str, ts_us: float,
              dur_us: float, args: dict | None = None) -> None:
        ev = {"ph": "X", "pid": 1, "tid": self._tid(track),
              "name": name, "ts": round(float(ts_us), 3),
              "dur": round(float(dur_us), 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def flow(self, name: str, src_track: str, src_ts_us: float,
             dst_track: str, dst_ts_us: float,
             args: dict | None = None) -> int:
        """One causal arrow (a Chrome-trace flow event pair):
        start on ``src_track`` at ``src_ts_us``, finish on
        ``dst_track`` at ``dst_ts_us`` — Perfetto renders it as an
        arrow between the enclosing slices.  Returns the flow id."""
        self._flow_id += 1
        fid = self._flow_id
        start = {"ph": "s", "pid": 1, "tid": self._tid(src_track),
                 "id": fid, "name": name, "cat": "flow",
                 "ts": round(float(src_ts_us), 3)}
        end = {"ph": "f", "pid": 1, "tid": self._tid(dst_track),
               "id": fid, "name": name, "cat": "flow", "bp": "e",
               "ts": round(float(dst_ts_us), 3)}
        if args:
            start["args"] = args
        self.events.append(start)
        self.events.append(end)
        return fid

    def counter(self, track: str, name: str, ts_us: float,
                value) -> None:
        # counters are per-(pid, name); the track prefix keeps series
        # from different subsystems apart in the UI
        self.events.append({"ph": "C", "pid": 1,
                            "name": f"{track}/{name}",
                            "ts": round(float(ts_us), 3),
                            "args": {name: int(value)}})

    def to_dict(self) -> dict:
        return {"schema": TIMELINE_SCHEMA,
                "displayTimeUnit": "ms",
                "otherData": {"name": self.name,
                              "us_per_round": US_PER_ROUND},
                "traceEvents": self.events}


def run_timeline(result: dict, *, name: str | None = None) -> dict:
    """Build the Perfetto timeline of one finished run from its
    verdict dict (a ``run_*_nemesis`` / ``run_serving`` result):
    rounds as slices, crash/loss/dup windows as a ``faults`` track,
    driven/drain phases as a ``traffic`` track, and every recorded
    telemetry series as a counter track."""
    u = US_PER_ROUND
    workload = result.get("workload", "run")
    tb = TimelineBuilder(name or f"{workload} run")
    tel = result.get("telemetry") or {}
    series = tel.get("series") or {}
    rounds_idx = series.get("_round") or []
    total = result.get("total_rounds")
    if total is None:
        total = (result.get("converged_round")
                 or result.get("clear_round") or 0)
    total = max(int(total), (rounds_idx[-1] + 1) if rounds_idx else 0)
    for t in range(min(total, _MAX_ROUND_SLICES)):
        tb.slice("rounds", f"round {t}", t * u, u)
    spec = result.get("spec") or {}
    for start, end, nodes in spec.get("crash", ()):
        tb.slice("faults", f"crash nodes={list(nodes)}", start * u,
                 (end - start) * u, args={"nodes": list(nodes)})
    if spec.get("loss_rate"):
        tb.slice("faults", f"loss p={spec['loss_rate']}", 0,
                 spec.get("loss_until", 0) * u)
    if spec.get("dup_rate"):
        tb.slice("faults", f"dup p={spec['dup_rate']}", 0,
                 spec.get("dup_until", 0) * u)
    tspec = result.get("traffic") or {}
    if tspec:
        until = int(tspec.get("until", 0))
        tb.slice("traffic", "driven (open-loop arrivals)", 0,
                 until * u, args={"rate": tspec.get("rate")})
        if total > until:
            tb.slice("traffic", "drain", until * u,
                     (total - until) * u)
        for start, end, mult in tspec.get("burst", ()):
            tb.slice("traffic", f"burst x{mult}", start * u,
                     (end - start) * u)
    for sname, vals in sorted(series.items()):
        if sname.startswith("_"):
            continue
        for t, v in zip(rounds_idx, vals):
            tb.counter("telemetry", sname, t * u, v)
    prov = result.get("provenance") or {}
    if (prov.get("spec") or {}).get("workload") == "broadcast" \
            and prov.get("arrays"):
        add_provenance_flows(tb, prov["arrays"])
    return tb.to_dict()


def add_provenance_flows(tb: TimelineBuilder, arrays: dict, *,
                         max_values: int = _MAX_FLOW_VALUES) -> int:
    """Draw a broadcast provenance record's dissemination trees as
    Perfetto FLOW events: per tree edge one ``node {src}``
    slice at the parent's arrival round, one ``node {dst}`` slice at
    the child's, and the causal arrow between them.  Only the
    ``max_values`` values with the DEEPEST trees are drawn (the
    critical-path ones — a full record is O(N·V) arrows); returns the
    number of flows emitted."""
    u = US_PER_ROUND
    arrival = np.asarray(arrays["arrival"])
    parent = np.asarray(arrays["parent"])
    depth = arrival.max(axis=0)                       # (V,)
    order = np.argsort(-depth)[:max_values]
    seen: set[tuple[int, int]] = set()
    n_flows = 0
    for v in order:
        if depth[v] < 1:
            continue
        for i in np.nonzero((arrival[:, v] > 0)
                            & (parent[:, v] >= 0))[0]:
            p, ac = int(parent[i, v]), int(arrival[i, v])
            ap = int(arrival[p, v])
            for node, t in ((p, ap), (int(i), ac)):
                if (node, t) not in seen:
                    seen.add((node, t))
                    tb.slice(f"node {node}", f"t{t}", t * u, u)
            tb.flow(f"v{int(v)}", f"node {p}", ap * u + u / 2,
                    f"node {int(i)}", ac * u + u / 2,
                    args={"value": int(v), "hop_rounds": ac - ap})
            n_flows += 1
    return n_flows


# -- dissemination trees ------------------------------------------------


def dissemination_tree(arrays: dict, *, max_edges: int = 16,
                       max_chain: int = 64) -> dict:
    """The per-value spanning trees of a broadcast provenance record
    (``arrival`` and ``parent``, (N, V) int32) with their hop latency:
    per value the nodes reached, the tree depth in hops against the
    arrival span in rounds and the mean hop latency; the critical path
    (the origin-to-leaf chain ending at the last arrival); the
    ``max_edges`` busiest directed edges with their use counts and mean
    hop latency (ties in the order the edges first occur).  The
    reference's result, its per-value and per-edge loops done as array
    reductions."""
    arrival = np.asarray(arrays["arrival"], np.int64)
    parent = np.asarray(arrays["parent"], np.int64)
    n, nv = arrival.shape
    child = (arrival > 0) & (parent >= 0)
    ii, vv = np.nonzero(child)
    pa = parent[ii, vv]
    hop = arrival[ii, vv] - arrival[pa, vv]           # per-edge rounds
    # depth by parent-pointer passes: depth[origin] = 0, depth[child] =
    # depth[parent] + 1
    depth = np.where(arrival == 0, 0, -1)
    for _ in range(n):
        pd = depth[pa, vv]
        upd = (depth[ii, vv] < 0) & (pd >= 0)
        if not upd.any():
            break
        depth[ii[upd], vv[upd]] = pd[upd] + 1
    reached = (arrival >= 0).sum(axis=0)
    origins = (arrival == 0).sum(axis=0)
    deepest = depth.max(axis=0) if n else np.zeros(nv, np.int64)
    span = arrival.max(axis=0) if n else np.zeros(nv, np.int64)
    n_hops = np.bincount(vv, minlength=nv)
    hop_sum = np.bincount(vv, weights=hop, minlength=nv)
    values = [{
        "value": v,
        "n_reached": int(reached[v]),
        "n_origins": int(origins[v]),
        "depth_hops": int(max(deepest[v], 0)),
        "span_rounds": int(span[v]),
        "mean_hop_rounds": (round(float(hop_sum[v] / n_hops[v]), 3)
                            if n_hops[v] else 0.0),
    } for v in range(nv) if reached[v]]
    # critical path: walk parents back from the globally last arrival
    chain = []
    if (arrival >= 0).any():
        flat = np.argmax(arrival)
        i, v = int(flat // nv), int(flat % nv)
        while len(chain) < max_chain:
            chain.append({"node": i, "round": int(arrival[i, v])})
            if arrival[i, v] <= 0 or parent[i, v] < 0:
                break
            i = int(parent[i, v])
        chain.reverse()
    edges = []
    if pa.size:
        keys, first, inv, counts = np.unique(
            pa * n + ii, return_index=True, return_inverse=True,
            return_counts=True)
        tot = np.bincount(inv, weights=hop)
        for e in np.lexsort((first, -counts))[:max_edges]:
            c, t = int(counts[e]), int(tot[e])
            edges.append({"src": int(keys[e] // n), "dst": int(keys[e] % n),
                          "n_values": c, "mean_hop_rounds": round(t / c, 3)})
    return {
        "schema": TREE_SCHEMA,
        "n_nodes": n,
        "n_values": nv,
        "n_tree_edges": int(child.sum()),
        "max_depth_hops": int(max(depth.max(), 0)) if depth.size else 0,
        "max_span_rounds": int(max(arrival.max(), 0)) if arrival.size
        else 0,
        "values": values,
        "critical_path": {
            "value": (chain and int(np.argmax(arrival) % nv)) or 0,
            "hops": max(len(chain) - 1, 0),
            "span_rounds": (int(chain[-1]["round"]) if chain else 0),
            "chain": chain,
        },
        "edges": edges,
    }


def validate_tree(d: dict) -> None:
    """Loud schema check of a dissemination-tree artifact."""
    if d.get("schema") != TREE_SCHEMA:
        raise ValueError(
            f"tree schema {d.get('schema')!r} != {TREE_SCHEMA!r}")
    for key in ("n_nodes", "n_values", "n_tree_edges", "values",
                "critical_path", "edges"):
        if key not in d:
            raise ValueError(f"dissemination tree missing {key!r}")
    for row in d["values"]:
        for key in ("value", "n_reached", "depth_hops", "span_rounds"):
            if key not in row:
                raise ValueError(f"tree value row missing {key!r}")
    cp = d["critical_path"]
    if cp["chain"]:
        rounds = [c["round"] for c in cp["chain"]]
        if rounds != sorted(rounds):
            raise ValueError("critical path rounds not monotone")
    for e in d["edges"]:
        if not (0 <= e["src"] < d["n_nodes"]
                and 0 <= e["dst"] < d["n_nodes"]):
            raise ValueError(f"edge out of range: {e}")


def validate_timeline(d: dict) -> None:
    """Loud schema check: raises ValueError on a malformed timeline (a
    flow without its pair, or one that finishes before it starts)."""
    if d.get("schema") != TIMELINE_SCHEMA:
        raise ValueError(
            f"timeline schema {d.get('schema')!r} != "
            f"{TIMELINE_SCHEMA!r}")
    events = d.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("timeline has no traceEvents")
    flows: dict = {}
    for ev in events:
        if ev.get("ph") not in ("M", "X", "C", "i", "s", "f"):
            raise ValueError(f"unknown event phase {ev.get('ph')!r}")
        if ev["ph"] in ("X", "C", "s", "f") and "ts" not in ev:
            raise ValueError(f"event missing ts: {ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"slice missing dur: {ev}")
        if ev["ph"] in ("s", "f"):
            if "id" not in ev:
                raise ValueError(f"flow event missing id: {ev}")
            flows.setdefault(ev["id"], []).append(ev)
    for fid, evs in flows.items():
        phs = sorted(e["ph"] for e in evs)
        if phs != ["f", "s"]:
            raise ValueError(
                f"flow {fid} is not a start/finish pair: {phs}")
        s_ev = next(e for e in evs if e["ph"] == "s")
        f_ev = next(e for e in evs if e["ph"] == "f")
        if f_ev["ts"] < s_ev["ts"]:
            raise ValueError(
                f"flow {fid} finishes before it starts (causality)")


# -- run manifests -------------------------------------------------------


def run_manifest(result: dict, *, programs: dict | None = None,
                 contracts: list | None = None,
                 extra: dict | None = None) -> dict:
    """The run manifest of a finished run's verdict dict: its config,
    specs, verdict and timings lifted from the result, ``env`` from
    torch, and the caller's ``programs`` ({name: record with a
    ``fingerprint``}) and ``contracts`` (audit rows)."""
    timing_keys = ("driven_s", "total_s", "wall_s", "ms_per_round")
    verdict_keys = ("ok", "clear_round", "converged_round",
                    "recovery_rounds", "n_lost_writes", "lost_writes",
                    "arrived", "issued", "deferred", "completed",
                    "in_flight", "conserved", "lat_p50", "lat_p99",
                    "lat_max", "msgs_total", "offered_per_round",
                    "sustained_per_round", "ops_per_sec")
    spec_keys = ("spec", "traffic", "telemetry")
    cuda = torch.cuda.is_available()
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": round(time.time(), 3),
        "workload": result.get("workload"),
        "env": {
            "torch": torch.__version__,
            "backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "device_name": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
        },
        "config": {k: v for k, v in result.items()
                   if k not in verdict_keys + spec_keys
                   and k not in timing_keys
                   and not isinstance(v, (list, dict))},
        "specs": {k: result[k] for k in spec_keys if k in result},
        "verdict": {k: result[k] for k in verdict_keys
                    if k in result},
        "timings": {k: result[k] for k in timing_keys
                    if k in result},
        "programs": programs or {},
        "contracts": contracts or [],
    }
    if extra:
        manifest.update(extra)
    return manifest


def validate_manifest(d: dict) -> None:
    """Loud schema check of a run manifest."""
    if d.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(
            f"manifest schema {d.get('schema')!r} != "
            f"{MANIFEST_SCHEMA!r}")
    for key in ("workload", "env", "specs", "verdict"):
        if key not in d:
            raise ValueError(f"manifest missing {key!r}")
    if "ok" not in d["verdict"]:
        raise ValueError("manifest verdict missing 'ok'")
    for name, rec in (d.get("programs") or {}).items():
        if "fingerprint" not in rec:
            raise ValueError(
                f"program record {name!r} missing fingerprint")


def validate_frontier(d: dict) -> None:
    """Loud schema check of a frontier report (``harness/frontier.py``
    ``run_frontier``): every cell row carries its grid coordinates, both
    verdicts and the SLO surface metrics; the failing list agrees with the
    per-cell verdicts; the coverage section (when present) accounts for
    every recorded signature."""
    if d.get("schema") != FRONTIER_SCHEMA:
        raise ValueError(
            f"frontier schema {d.get('schema')!r} != "
            f"{FRONTIER_SCHEMA!r}")
    for key in ("workload", "ok", "n_cells", "slo", "slo_ok",
                "serving_ok", "failing", "cells"):
        if key not in d:
            raise ValueError(f"frontier report missing {key!r}")
    if d["n_cells"] != len(d["cells"]):
        raise ValueError(
            f"n_cells {d['n_cells']} != len(cells) "
            f"{len(d['cells'])}")
    failing = set()
    for i, cell in enumerate(d["cells"]):
        for key in ("coords", "ok", "slo_ok", "lat_p99",
                    "sustained_per_round", "completed"):
            if key not in cell:
                raise ValueError(f"frontier cell {i} missing "
                                 f"{key!r}")
        if not (cell["ok"] and cell["slo_ok"]):
            failing.add(i)
    if failing != set(d["failing"]):
        raise ValueError(
            f"failing list {sorted(d['failing'])} disagrees with "
            f"per-cell verdicts {sorted(failing)}")
    if bool(d["ok"]) != (not failing):
        raise ValueError("top-level ok disagrees with cells")
    cov = d.get("coverage")
    if cov is not None:
        if cov["n_distinct"] != len(cov["signatures"]):
            raise ValueError("coverage n_distinct != signatures")
        if cov["n_seen"] != sum(r["count"]
                                for r in cov["signatures"]):
            raise ValueError("coverage n_seen != sum of counts")


# -- atomic JSON writes --------------------------------------------------


def write_json_atomic(path: str, payload: dict) -> str:
    """Write ``payload`` as JSON via tmp-file + ``os.replace`` — the
    flight-recorder durability contract: a reader (or a crashed
    writer) can never observe a half-written artifact."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".",
        prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "w") as fp:
            json.dump(payload, fp, indent=1, sort_keys=True)
            fp.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


# -- flight recorder -----------------------------------------------------


def write_flight_bundle(out_dir: str, *, kind: str, workload: str,
                        nemesis: dict | None = None,
                        traffic: dict | None = None,
                        sim_kw: dict | None = None,
                        runner_kw: dict | None = None,
                        telemetry_spec: dict | None = None,
                        telemetry_series: dict | None = None,
                        provenance_spec: dict | None = None,
                        provenance: dict | None = None,
                        failure: dict | None = None) -> str:
    """Write the one-file repro bundle for a failed run (module
    docstring).  ``kind``: ``"nemesis"`` (a ``run_*_nemesis``
    campaign) or ``"serving"`` (a ``run_serving`` open-loop run).
    ``provenance_spec``/``provenance``: the ProvenanceSpec
    meta and recorded stamp arrays (as nested lists) — the replay
    re-records and diffs them for the first-divergence round.
    Everything needed to replay rides inside; the write is atomic."""
    if kind not in ("nemesis", "serving"):
        raise ValueError(f"unknown bundle kind {kind!r}")
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "created_unix": round(time.time(), 3),
        "kind": kind,
        "workload": workload,
        "nemesis": nemesis,
        "traffic": traffic,
        "sim_kw": sim_kw or {},
        "runner_kw": runner_kw or {},
        "telemetry_spec": telemetry_spec,
        "telemetry_series": telemetry_series,
        "provenance_spec": provenance_spec,
        "provenance": provenance,
        "failure": failure or {},
    }
    seed_bits = []
    if nemesis:
        seed_bits.append(f"n{nemesis.get('seed', 0)}")
    if traffic:
        seed_bits.append(f"t{traffic.get('seed', 0)}")
    stem = (f"flight_{workload}_{kind}_"
            f"{'_'.join(seed_bits) or 'seedless'}")
    # never clobber an earlier failure's repro: distinct failures can
    # share (workload, kind, seeds) — e.g. a fuzzer sweeping bounds —
    # so suffix until the name is free
    path = os.path.join(out_dir, f"{stem}.json")
    i = 2
    while os.path.exists(path):
        path = os.path.join(out_dir, f"{stem}_{i}.json")
        i += 1
    return write_json_atomic(path, bundle)


def load_bundle(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        bundle = path_or_dict
    else:
        with open(path_or_dict) as fp:
            bundle = json.load(fp)
    if bundle.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"not a flight bundle (schema "
            f"{bundle.get('schema')!r} != {BUNDLE_SCHEMA!r})")
    return bundle


def replay_divergence(bundle: dict, result: dict) -> int | None:
    """First round at which a replay's re-recorded observability
    record disagrees with its bundle — ``None`` for a faithful
    replay.  Checks the telemetry series
    (checkers.series_divergence_round) and the provenance stamps
    (checkers.provenance_divergence_round); the minimum firing round
    wins: a shrunk fault spec whose replay diverges earlier than the
    failure round changed the trajectory, not just the verdict."""
    from .checkers import (provenance_divergence_round,
                           series_divergence_round)

    cands = []
    exp_series = bundle.get("telemetry_series")
    got_series = (result.get("telemetry") or {}).get("series")
    if exp_series and got_series:
        d = series_divergence_round(exp_series, got_series)
        if d is not None:
            cands.append(d)
    exp_prov = bundle.get("provenance")
    got_prov = (result.get("provenance") or {}).get("arrays")
    if exp_prov and got_prov:
        d = provenance_divergence_round(exp_prov, got_prov)
        if d is not None:
            cands.append(d)
    return min(cands) if cands else None


def replay_bundle(path_or_dict, *, telemetry=False, mesh=None,
                  device: str | torch.device | None = None) -> dict:
    """Re-run a flight bundle's campaign from its own JSON alone, on
    ``device`` (CUDA unless given), and return the fresh verdict dict:
    every run is a pure function of its seeded specs, so the replay
    reproduces the recorded failure.  When the bundle carries a recorded
    telemetry series or provenance stamps, the replay re-records them
    (the bundle's own spec) and reports
    ``result['first_divergence_round']`` (:func:`replay_divergence`: None
    for a faithful replay).  ``mesh`` raises (ROADMAP.md Queue A item
    10), as does a bundle whose ``runner_kw`` names a ``dcn_mode``."""
    from ..tpu_sim.faults import NemesisSpec
    from ..tpu_sim.traffic import TrafficSpec
    from . import nemesis as NM
    from . import serving as SV
    from . import txn as TXH

    if mesh is not None:
        raise _unported("observe.replay_bundle(mesh=...)", 10)
    bundle = load_bundle(path_or_dict)
    spec = (NemesisSpec.from_meta(bundle["nemesis"])
            if bundle.get("nemesis") else None)
    has_record = bool(bundle.get("telemetry_series")
                      or bundle.get("provenance"))
    if bundle.get("telemetry_series"):
        telemetry = (telemetry
                     or TM.TelemetrySpec.from_meta(
                         bundle["telemetry_spec"]))
    if bundle["kind"] == "serving":
        if not bundle.get("traffic"):
            raise ValueError("serving bundle has no traffic spec")
        kw = dict(bundle.get("runner_kw") or {})
        result = SV.run_serving(
            bundle["workload"], TrafficSpec.from_meta(bundle["traffic"]),
            nemesis=spec, sim_kw=bundle.get("sim_kw") or {},
            telemetry=telemetry, device=device, **kw)
    else:
        runners = {"broadcast": NM.run_broadcast_nemesis,
                   "counter": NM.run_counter_nemesis,
                   "kafka": NM.run_kafka_nemesis,
                   "txn": TXH.run_txn_nemesis}
        if spec is None:
            raise ValueError("nemesis bundle has no NemesisSpec")
        kw = dict(bundle.get("runner_kw") or {})
        if bundle.get("traffic"):
            kw["traffic"] = TrafficSpec.from_meta(bundle["traffic"])
        if bundle.get("provenance_spec"):
            kw["provenance"] = PV.ProvenanceSpec.from_meta(
                bundle["provenance_spec"])
        result = runners[bundle["workload"]](spec, telemetry=telemetry,
                                             device=device, **kw)
    if has_record:
        result["first_divergence_round"] = replay_divergence(bundle,
                                                             result)
    return result


# -- optional torch.profiler capture --------------------------------------


@contextlib.contextmanager
def profiled(out_dir: str | None):
    """Optional ``torch.profiler`` capture: ``with observe.profiled(dir):``
    records the CPU and, where there is one, the CUDA activity of the
    block and exports it as a Chrome trace ``trace_<pid>_<ns>.json`` into
    ``dir``; a clean no-op when ``out_dir`` is None or the profiler cannot
    start (another capture running), and the export never fails the run:
    observability must not."""
    if out_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        yield None
        return
    try:
        yield out_dir
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(
                out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
        except Exception:
            pass
