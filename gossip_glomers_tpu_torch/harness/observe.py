"""Run observation on the host: a partial port of
gossip_glomers_tpu/harness/observe.py — how the runners resolve their
``telemetry=`` and ``provenance=`` arguments, and the dissemination trees
rebuilt from a broadcast provenance record.

- :func:`telemetry_setup` / :func:`provenance_setup`: a runner's
  argument (None: the ``GG_TELEMETRY`` / ``GG_PROVENANCE`` switch; True /
  False; a spec) to a spec or None.
- :func:`dissemination_tree` / :func:`validate_tree`: per-value spanning
  trees, the critical path and the busiest edges of a broadcast record
  (:func:`..tpu_sim.provenance.arrays_of`), as JSON-able data.

Pure host code over numpy; tests/test_torch_provenance.py holds each
function equal to the reference's.  Not ported yet, and raising: the
flight-recorder bundle (``write_flight_bundle``, ``load_bundle``,
``replay_bundle``), the Perfetto timelines (``run_timeline``, the
provenance flows) and the profiler capture (ROADMAP.md Queue A item 13).
"""

from __future__ import annotations

import numpy as np

from ..tpu_sim import provenance as PV
from ..tpu_sim import telemetry as TM

TREE_SCHEMA = "gg-dissemination-tree/1"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               "(ROADMAP.md Queue A item 13)")


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


def write_flight_bundle(out_dir: str, **kw):
    """The flight-recorder repro bundle: Queue A item 13."""
    raise _unported("observe.write_flight_bundle")


def load_bundle(path_or_dict):
    raise _unported("observe.load_bundle")


def replay_bundle(path_or_dict, **kw):
    raise _unported("observe.replay_bundle")


def run_timeline(result: dict, **kw):
    """The Perfetto timeline with the provenance flows: Queue A item
    13."""
    raise _unported("observe.run_timeline")
