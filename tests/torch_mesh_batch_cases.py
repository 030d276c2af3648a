"""Rank-side cases of tests/test_torch_mesh_batches.py: module-level
functions that a spawned rank of ``dcn_worker.spawn_world`` runs as
``fn(mesh, ...)``, and that the tests also run in one process
(``mesh=None``, on the CPU).  One world runs every case on the whole
4-rank mesh and the batches on a 2-rank mesh of ranks 0 and 1.  The
batches and their inputs are made from seeds by the functions below,
which the tests also hand (as metas) to the JAX package.  Results come
back whole on every rank (the collect step gathers them), as numpy.  No
JAX here: the ranks import this module."""

import os

import numpy as np
import torch

from torch_mesh_fault_cases import _before, _calls, _sub
from gossip_glomers_tpu_torch.harness import frontier as FR
from gossip_glomers_tpu_torch.harness import fuzz as FZ
from gossip_glomers_tpu_torch.harness import txn as HT
from gossip_glomers_tpu_torch.parallel.topology import (grid,
                                                         to_padded_neighbors)
from gossip_glomers_tpu_torch.tpu_sim import engine, faults
from gossip_glomers_tpu_torch.tpu_sim import scenario as SC
from gossip_glomers_tpu_torch.tpu_sim import telemetry as TM
from gossip_glomers_tpu_torch.tpu_sim import traffic as T

# -- the batches, shared with the JAX side --------------------------------------

#: tests/test_scenario.py:91's ring: 8 + 32 rounds
BROADCAST_TEL = 40
#: the frontier's grid (tests/test_torch_frontier.py's) and its SLO, which
#: fails the grid's loaded cells (their bundles are written)
FRONTIER_GRID = dict(n_nodes=8, rates=(0.3, 0.6),
                     fault_levels=(None, {"n_crash_windows": 1,
                                          "loss_rate": 0.1}),
                     until=8, seed=3)
FRONTIER_KW = dict(slo={"p99_max_rounds": 3}, max_recovery_rounds=16,
                   drain_every=4, pipeline=True)
#: tests/test_torch_fuzz.py's planted campaign, shrunk once
FUZZ_KW = dict(workload="broadcast", n_scenarios=16, n_nodes=12,
               batch_size=8, horizon=6, max_recovery_rounds=16, seed=7,
               plant_failure=True, max_shrinks=1)
#: the batch sizes whose placement the ranks report
PLACEMENT_SIZES = (1, 2, 3, 4, 6, 8, 12, 16)
#: the txn frontier: four specs a rate, so a column divides over the ranks
TXN_FRONTIER_RATES = (0.3, 0.7)
TXN_FRONTIER_KW = dict(n_keys=8, txns_per_node=3, until=8,
                       max_recovery_rounds=32,
                       slo={"p99_max_rounds": 6.0,
                            "max_recovery_rounds": 20})


def hetero_specs(n: int, count: int = 6, horizon: int = 8) -> list:
    """tests/test_scenario.py's specs: 0, 1 or 2 crash windows, loss on
    odd seeds, dup on every third."""
    return [faults.random_spec(n, seed=s, horizon=horizon,
                               n_crash_windows=s % 3,
                               loss_rate=0.1 * (s % 2),
                               dup_rate=0.05 * (s % 3 == 0))
            for s in range(1, count + 1)]


def broadcast_batch(delayed: bool) -> SC.ScenarioBatch:
    """tests/test_scenario.py:91: 6 scenarios on the 24-node grid,
    partition windows on odd ones, per-edge delays 1-2 (or one hop)."""
    n, nv = 24, 48
    nbrs = to_padded_neighbors(grid(n))
    rng = np.random.default_rng(0)
    cases = []
    for i, sp in enumerate(hetero_specs(n)):
        parts = None
        if i % 2 == 1:
            g = (np.arange(n) % 2).astype(int)
            parts = {"starts": [2], "ends": [5], "group": [g.tolist()]}
        delays = tuple(tuple(int(v) for v in row)
                       for row in rng.integers(1, 3, nbrs.shape))
        cases.append(SC.Scenario(spec=sp, parts=parts,
                                 delays=delays if delayed else None))
    return SC.ScenarioBatch(
        workload="broadcast", scenarios=tuple(cases),
        runner_kw={"n_values": nv, "topology": "grid", "sync_every": 4},
        max_recovery_rounds=32)


def counter_batch() -> SC.ScenarioBatch:
    """tests/test_scenario.py:158: 4 scenarios, crash after the drain."""
    n = 16
    specs = []
    for s in range(1, 5):
        meta = faults.random_spec(n, seed=s, horizon=8,
                                  n_crash_windows=1 + (s % 2),
                                  loss_rate=0.1).to_meta()
        meta["crash"] = [[a + n + 2, b + n + 2, ns]
                         for a, b, ns in meta["crash"]]
        meta["loss_until"] += n + 2
        specs.append(faults.NemesisSpec.from_meta(meta))
    return SC.ScenarioBatch(
        workload="counter", scenarios=tuple(SC.Scenario(spec=sp)
                                            for sp in specs),
        runner_kw={"mode": "cas", "poll_every": 2}, max_recovery_rounds=48)


def kafka_batch() -> SC.ScenarioBatch:
    """tests/test_scenario.py:196: 4 scenarios, seeded sends."""
    specs = [faults.random_spec(16, seed=10 + s, horizon=8,
                                n_crash_windows=1 + (s % 2), loss_rate=0.1)
             for s in range(4)]
    return SC.ScenarioBatch(
        workload="kafka",
        scenarios=tuple(SC.Scenario(spec=sp, workload_seed=sp.seed)
                        for sp in specs),
        runner_kw={"n_keys": 4, "capacity": 64, "max_sends": 2,
                   "resync_every": 4, "send_prob": 0.7},
        max_recovery_rounds=24)


def txn_batch() -> SC.ScenarioBatch:
    """tests/test_txn.py:197: 64 fuzzed crash + loss campaigns."""
    scs = FZ.sample_scenarios("txn", 64, n_nodes=16, seed=3, horizon=8)
    return SC.ScenarioBatch(
        workload="txn", scenarios=tuple(scs),
        runner_kw=dict(n_keys=8, txns_per_node=4, ops_per_txn=2, rate=0.5,
                       until=16),
        max_recovery_rounds=48)


def tel_spec(batch: SC.ScenarioBatch):
    """The batch's telemetry ring: the reference test's rounds."""
    if batch.workload == "broadcast":
        return TM.TelemetrySpec("broadcast", rounds=BROADCAST_TEL)
    rounds = max(sc.spec.clear_round for sc in batch.scenarios) + \
        batch.max_recovery_rounds
    return TM.TelemetrySpec(batch.workload, rounds=rounds)


def serving_batch() -> SC.ServingBatch:
    """tests/test_frontier.py:158: 8 broadcast cells, mixed topologies,
    loads and plans."""
    n = 16
    spec = faults.NemesisSpec(n_nodes=n, crash=((2, 5, (3, 4)),),
                              loss_rate=0.1, loss_until=6)
    cells = [SC.ServingCell(
        traffic=T.TrafficSpec(n_nodes=n, n_clients=n, ops_per_client=2,
                              until=8, rate=0.2 + 0.05 * i, seed=i),
        spec=(spec if i % 2 else None),
        topology="tree" if i % 3 == 0 else "grid") for i in range(8)]
    return SC.ServingBatch(workload="broadcast", cells=tuple(cells),
                           max_recovery_rounds=16, drain_every=4)


def txn_frontier_specs() -> list:
    return [faults.NemesisSpec(n_nodes=8, seed=3),
            faults.NemesisSpec(n_nodes=8, seed=5, crash=((2, 5, (1, 6)),),
                               loss_rate=0.2, loss_until=6),
            faults.NemesisSpec(n_nodes=8, seed=7, loss_rate=0.3,
                               loss_until=5),
            faults.NemesisSpec(n_nodes=8, seed=9, crash=((1, 4, (0, 3)),))]


# -- helpers -------------------------------------------------------------------


def _np(x):
    """A result with its tensors (and state trees, as dicts) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_np(v) for v in x)
    if hasattr(x, "_fields"):
        return {f: _np(getattr(x, f)) for f in x._fields}
    if hasattr(x, "__dataclass_fields__"):
        return {f: _np(getattr(x, f)) for f in x.__dataclass_fields__}
    return x


def _place(mesh) -> dict:
    return {"mesh": mesh} if mesh is not None else {"device": "cpu"}


def strip_walls(res: dict, walls) -> dict:
    return {k: v for k, v in res.items() if k not in walls}


FRONTIER_WALL = ("dispatch_s", "batch_walls_s", "cells_per_sec", "total_s")
FUZZ_WALL = ("batch_walls_s", "sample_s", "dispatch_s", "total_s",
             "scenarios_per_sec", "scenarios_per_sec_steady")


# -- the cases -----------------------------------------------------------------


def scenario_cases(mesh) -> dict:
    """Each scenario batch through ``dispatch_scenario_batch`` /
    ``collect_scenario_batch`` (its census split at the collect), with
    telemetry and, for broadcast, signatures; the txn batch through
    ``run_txn_batch`` unpadded."""
    out = {}
    place = _place(mesh)
    for name, batch in (("broadcast_delayed", broadcast_batch(True)),
                        ("broadcast_one_hop", broadcast_batch(False)),
                        ("counter", counter_batch()),
                        ("kafka", kafka_batch())):
        before = _before(mesh)
        handle = SC.dispatch_scenario_batch(
            batch, telemetry_spec=tel_spec(batch),
            signatures=batch.workload == "broadcast", **place)
        trip = _calls(mesh, before)
        before = _before(mesh)
        res = SC.collect_scenario_batch(handle)
        out[name] = {"res": _np(res), "trip_calls": trip,
                     "collect_calls": _calls(mesh, before)}
    before = _before(mesh)
    res = SC.run_txn_batch(txn_batch(), **place)
    out["txn"] = {"res": _np(res), "calls": _calls(mesh, before)}
    return out


def serving_cases(mesh) -> dict:
    """The 8-cell serving grid (its census split at the collect), and the
    same grid padded: 6 of its cells on 4 ranks."""
    place = _place(mesh)
    batch = serving_batch()
    before = _before(mesh)
    handle = SC.dispatch_serving_batch(batch, telemetry_spec=True,
                                       signatures=True, **place)
    trip = _calls(mesh, before)
    before = _before(mesh)
    res = SC.collect_serving_batch(handle)
    out = {"grid": {"res": _np(res), "trip_calls": trip,
                    "collect_calls": _calls(mesh, before)}}
    six = SC.ServingBatch(workload="broadcast", cells=batch.cells[:6],
                          max_recovery_rounds=16, drain_every=4)
    out["six"] = _np(SC.run_serving_batch(six, **place))
    return out


def _bundle_names(out_dir: str) -> list:
    return sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []


def runner_cases(mesh, out_dir: str) -> dict:
    """``run_frontier``, ``fuzz_run`` (the planted failure shrunk, its
    candidates, bundle and replay on the mesh) and ``run_txn_frontier``
    on the mesh.  ``out_dir``: one directory every rank sees, as a
    cluster's shared file system: the ranks agree on each bundle's name
    and rank 0 writes it once."""
    place = _place(mesh)
    out = {}
    fr_dir, fz_dir = (os.path.join(out_dir, "frontier"),
                      os.path.join(out_dir, "fuzz"))
    rep = FR.run_frontier(
        "broadcast", FR.frontier_grid("broadcast", **FRONTIER_GRID),
        observe_dir=fr_dir, **FRONTIER_KW, **place)
    rep["bundles"] = [dict(b, path=os.path.basename(b["path"]))
                      for b in rep["bundles"]]
    out["frontier"] = _np(strip_walls(rep, FRONTIER_WALL))
    out["frontier_files"] = _bundle_names(fr_dir)
    res = FZ.fuzz_run(**FUZZ_KW, observe_dir=fz_dir, **place)
    res["shrinks"] = [dict(s, bundle=os.path.basename(s["bundle"]))
                      for s in res["shrinks"]]
    out["fuzz"] = _np(strip_walls(res, FUZZ_WALL))
    out["fuzz_files"] = _bundle_names(fz_dir)
    out["txn_frontier"] = HT.run_txn_frontier(
        TXN_FRONTIER_RATES, txn_frontier_specs(), **TXN_FRONTIER_KW,
        **place)
    return out


def placement(mesh) -> dict:
    return {s: engine.scenario_placement(s, mesh) for s in PLACEMENT_SIZES}


def batch_world(mesh, out_dir: str) -> dict:
    """Everything test_torch_mesh_batches.py reads: every case on the
    4-rank mesh, the scenario and serving batches on the 2-rank mesh of
    ranks 0 and 1."""
    out = {4: {"scenario": scenario_cases(mesh),
               "serving": serving_cases(mesh),
               "runners": runner_cases(mesh, out_dir),
               "placement": placement(mesh)}}
    m2 = _sub(mesh, 2)
    if m2 is not None:
        out[2] = {"scenario": scenario_cases(m2),
                  "serving": serving_cases(m2), "placement": placement(m2)}
    mesh.agree(True)      # ranks 2 and 3 wait for the 2-rank cases
    return out
