"""Scenario and serving batches on a mesh, and the frontier, fuzz and
txn-frontier runners' ``mesh=``, against the JAX package's 8-device mesh,
on the reference's own mesh cases: tests/test_scenario.py
``test_broadcast_batch_matches_sequential`` (6 scenarios, which its mesh
pads to 8; here 4 ranks pad them to 8 and 2 ranks take 3 each, one hop
and delayed), ``test_counter_batch_matches_sequential`` and
``test_kafka_batch_matches_sequential`` with ``mesh_on=True``;
tests/test_frontier.py ``test_serving_parity_broadcast_mesh8``;
tests/test_txn.py ``test_batch_64_fuzzed_scenarios_certify_in_one_dispatch``;
and the frontier, the planted fuzz campaign (its shrinker's runs and its
replay on the mesh too) and the txn frontier.

Every row, telemetry series, signature and stacked final state is equal
on 4 ranks and on 2, to the JAX package's mesh run and to the port's
one-process run.  The port runs in one spawned world of 4 gloo ranks on
the CPU (``torch_mesh_batch_cases``, its 2-rank cases on a subgroup of
ranks 0 and 1).  The census: no collective inside a trip (each rank runs
its block of whole scenarios on one-process sims), and one gather when a
batch is collected."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import torch_mesh_batch_cases as X
from gossip_glomers_tpu.harness import frontier as JFR
from gossip_glomers_tpu.harness import fuzz as JFZ
from gossip_glomers_tpu.harness import txn as JHT
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import scenario as JSC
from gossip_glomers_tpu.tpu_sim import telemetry as JTM
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import engine

WORLD_TIMEOUT = 300.0
NONE = {"ppermute": 0, "all_gather": 0, "all_reduce": 0}
ONE_GATHER = {"ppermute": 0, "all_gather": 1, "all_reduce": 0}


def mesh_1d():
    return JMesh(np.array(jax.devices()).reshape(8), ("nodes",))


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if isinstance(x, np.floating):
        return float(x)
    return x


def _strip(x):
    """A rank's result without its collective census."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if not str(k).endswith("calls")}
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("world"))
    ranks = dcn_worker.spawn_world(X.batch_world, 4, backend="gloo",
                                   device="cpu", args=(out_dir,),
                                   timeout=WORLD_TIMEOUT)
    for p, members in ((4, ranks), (2, ranks[:2])):
        for r in members[1:]:
            assert _norm(_strip(r[p])) == _norm(_strip(members[0][p])), p
    return {4: ranks[0][4], 2: ranks[0][2]}


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return {"scenario": X.scenario_cases(None),
            "serving": X.serving_cases(None),
            "runners": X.runner_cases(
                None, str(tmp_path_factory.mktemp("one")))}


def _jbatch(batch):
    return JSC.ScenarioBatch.from_meta(batch.to_meta())


def _jtel(spec):
    return JTM.TelemetrySpec.from_meta(spec.to_meta())


def _rows_equal(got: dict, want: dict, what) -> None:
    """A batch result's rows, verdict, telemetry and signatures."""
    for k in ("ok", "failing", "n_scenarios", "scenarios"):
        assert _norm(got[k]) == _norm(want[k]), (what, k)
    for k in ("telemetry", "signatures"):
        assert (k in got) == (k in want), (what, k)
        if k in want:
            assert _norm(got[k]) == _norm(np.asarray(want[k])
                                          if k == "signatures"
                                          else want[k]), (what, k)


def _u32(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


# -- scenario batches ------------------------------------------------------------


BATCHES = {"broadcast_delayed": lambda: X.broadcast_batch(True),
           "broadcast_one_hop": lambda: X.broadcast_batch(False),
           "counter": X.counter_batch, "kafka": X.kafka_batch}


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("p", (4, 2))
def test_scenario_batch_on_mesh(world, one, p, name):
    batch = BATCHES[name]()
    s = len(batch.scenarios)
    want = JSC.run_scenario_batch(
        _jbatch(batch), mesh=mesh_1d(),
        telemetry_spec=_jtel(X.tel_spec(batch)),
        signatures=batch.workload == "broadcast")
    got, o = world[p]["scenario"][name], one["scenario"][name]
    _rows_equal(got["res"], want, (p, name, "jax"))
    _rows_equal(got["res"], o["res"], (p, name, "one process"))
    # the stacked final states (fillers past the rows kept, as the
    # reference keeps them)
    if batch.workload == "broadcast":
        fields, jfinal = ("received", "frontier"), want["final"]
    elif batch.workload == "counter":
        fields, jfinal = ("pending", "cached", "kv", "msgs"), want["final"]
    else:
        fields, jfinal = ("present", "log_vals", "msgs"), want["final"]
    for f in fields:
        mine = _u32(got["res"]["final"][f])[:s]
        np.testing.assert_array_equal(mine, _u32(getattr(jfinal, f))[:s],
                                      err_msg=f"{name} {f}")
        np.testing.assert_array_equal(
            mine, _u32(o["res"]["final"][f])[:s], err_msg=f"{name} {f}")
    # placement: 4 ranks pad 6 scenarios to 8, 2 ranks take 3 each
    padded = -(-s // p) * p
    assert world[p]["placement"][padded] == "scenario"
    assert _u32(got["res"]["final"][fields[0]]).shape[0] == padded
    # no collective inside the trip, one gather at collect
    assert got["trip_calls"] == NONE
    assert got["collect_calls"] == ONE_GATHER


@pytest.mark.parametrize("p", (4, 2))
def test_txn_batch_64_on_mesh(world, one, p):
    batch = X.txn_batch()
    want = JSC.run_txn_batch(_jbatch(batch), mesh=mesh_1d())
    got, o = world[p]["scenario"]["txn"], one["scenario"]["txn"]
    assert want["ok"] and got["res"]["ok"]
    for k in ("ok", "failing", "scenarios"):
        assert _norm(got["res"][k]) == _norm(want[k]), k
        assert _norm(got["res"][k]) == _norm(o["res"][k]), k
    for f in ("issue_round", "commit_round", "op_ver", "op_val"):
        np.testing.assert_array_equal(got["res"]["final"][f],
                                      np.asarray(getattr(want["final"], f)))
    assert len(got["res"]["scenarios"]) == 64
    assert got["calls"] == ONE_GATHER


@pytest.mark.parametrize("p", (4, 2))
def test_placement_rule_is_the_reference_s(world, p):
    from gossip_glomers_tpu.tpu_sim.engine import scenario_placement as jsp

    jmesh = JMesh(np.array(jax.devices()[:p]), ("nodes",))
    got = world[p]["placement"]
    assert got == {s: jsp(s, jmesh) for s in X.PLACEMENT_SIZES}
    assert engine.scenario_placement(4, None) == jsp(4, None) == "single"


# -- serving batches ---------------------------------------------------------------


@pytest.mark.parametrize("p", (4, 2))
def test_serving_batch_on_mesh(world, one, p):
    batch = X.serving_batch()
    jb = JSC.ServingBatch.from_meta(batch.to_meta())
    want = JSC.run_serving_batch(jb, mesh=mesh_1d(), telemetry_spec=True,
                                 signatures=True)
    got, o = world[p]["serving"]["grid"], one["serving"]["grid"]
    for k in ("ok", "failing", "n_cells", "cells", "telemetry"):
        assert _norm(got["res"][k]) == _norm(want[k]), k
        assert _norm(got["res"][k]) == _norm(o["res"][k]), k
    assert _norm(got["res"]["signatures"]) == _norm(
        np.asarray(want["signatures"]))
    assert got["trip_calls"] == NONE
    assert got["collect_calls"] == ONE_GATHER
    # 6 cells: padded to 8 on 4 ranks, the fillers dropped
    six = JSC.ServingBatch.from_meta(dict(jb.to_meta(), cells=[
        c.to_meta() for c in jb.cells[:6]]))
    want6 = JSC.run_serving_batch(six, mesh=mesh_1d())
    got6 = world[p]["serving"]["six"]
    assert got6["n_cells"] == 6
    assert _norm(got6["cells"]) == _norm(want6["cells"]) == _norm(
        one["serving"]["six"]["cells"])
    assert np.asarray(got6["trackers"]["issued_k"]).shape[0] == 6


# -- the runners -------------------------------------------------------------------


def test_run_frontier_on_mesh(world, one, tmp_path):
    from gossip_glomers_tpu.harness import observe as JO

    want = JFR.run_frontier(
        "broadcast", JFR.frontier_grid("broadcast", **X.FRONTIER_GRID),
        observe_dir=str(tmp_path), mesh=mesh_1d(), **X.FRONTIER_KW)
    JO.validate_frontier(want)
    want = {k: v for k, v in want.items() if k not in X.FRONTIER_WALL}
    want["bundles"] = [dict(b, path=os.path.basename(b["path"]))
                       for b in want["bundles"]]
    got, o = world[4]["runners"], one["runners"]
    assert not got["frontier"]["ok"] and got["frontier"]["bundles"]
    assert _norm(got["frontier"]) == _norm(want)
    assert _norm(got["frontier"]) == _norm(o["frontier"])
    # each failing cell's bundle written once, by rank 0
    assert got["frontier_files"] == o["frontier_files"] == sorted(
        b["path"] for b in want["bundles"])


def test_fuzz_run_on_mesh(world, one, tmp_path):
    want = JFZ.fuzz_run(**X.FUZZ_KW, observe_dir=str(tmp_path),
                        mesh=mesh_1d())
    want = {k: v for k, v in want.items() if k not in X.FUZZ_WALL}
    want["shrinks"] = [dict(s, bundle=os.path.basename(s["bundle"]))
                       for s in want["shrinks"]]
    got, o = world[4]["runners"], one["runners"]
    fz = got["fuzz"]
    assert fz["n_failing"] == 1 and fz["failing"][0]["index"] == 0
    rec = fz["shrinks"][0]
    assert rec["replay_same_failure"]
    assert rec["weight_after"] < rec["weight_before"]
    assert _norm(fz) == _norm(want)
    assert _norm(fz) == _norm(o["fuzz"])
    assert got["fuzz_files"] == o["fuzz_files"]
    assert rec["bundle"] in got["fuzz_files"]


def test_run_txn_frontier_on_mesh(world, one):
    specs = [JF.NemesisSpec.from_meta(s.to_meta())
             for s in X.txn_frontier_specs()]
    want = JHT.run_txn_frontier(X.TXN_FRONTIER_RATES, specs, mesh=mesh_1d(),
                                **X.TXN_FRONTIER_KW)
    got = world[4]["runners"]["txn_frontier"]
    assert got["n_cells"] == 8
    assert _norm(got) == _norm(want)
    assert _norm(got) == _norm(one["runners"]["txn_frontier"])
