"""The port's flight recorder and timelines (gossip_glomers_tpu_torch/
harness/observe.py) against the JAX package's on the CPU: the Perfetto
timeline of a provenance-on campaign equals the reference's and passes
the shared golden (tests/data/timeline_golden.json); the validators, the
atomic JSON write and the manifest schema behave as the reference's; a
flight bundle written by either package's runner (broadcast on the gather
path with provenance and on the structured path, counter, Kafka, txn,
serving) replays in the other to the same verdict with
``first_divergence_round`` None; the profiler capture leaves a Chrome
trace; and BroadcastSim's ``run_staged``, ``inject_mid``, ``run_stats``
and ``read`` equal the reference's on the gather and words-major paths.
"""

import json
import os

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import nemesis as JN
from gossip_glomers_tpu.harness import observe as JO
from gossip_glomers_tpu.harness import serving as JSV
from gossip_glomers_tpu.harness import txn as JH
from gossip_glomers_tpu.parallel.topology import to_padded_neighbors, tree
from gossip_glomers_tpu.tpu_sim import broadcast as JB
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import structured as JS
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu_torch.harness import nemesis as PN
from gossip_glomers_tpu_torch.harness import observe as PO
from gossip_glomers_tpu_torch.harness import serving as PSV
from gossip_glomers_tpu_torch.harness import txn as PH
from gossip_glomers_tpu_torch.tpu_sim import broadcast as PB
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import structured as PS
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "timeline_golden.json")


def _jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def _validate_against_golden(tl, golden):
    PO.validate_timeline(tl)
    assert tl["schema"] == golden["schema"]
    assert tl["displayTimeUnit"] == golden["displayTimeUnit"]
    for key in golden["required_top"]:
        assert key in tl, key
    assert set(golden["required_phases"]) <= {e["ph"]
                                              for e in tl["traceEvents"]}
    for ev in tl["traceEvents"]:
        for f in golden["phase_fields"].get(ev["ph"], ()):
            assert f in ev, (ev["ph"], f, ev)


def test_timeline_golden_and_equal_to_reference():
    # tests/test_provenance.py:421's campaign on the port: its timeline
    # passes the shared golden with flow arrows, and equals the
    # reference's timeline of the reference's own run
    kw = dict(n_nodes=16, seed=5, crash=((2, 5, (1, 8)),), loss_rate=0.15,
              loss_until=8)
    res = PN.run_broadcast_nemesis(PF.NemesisSpec(**kw), provenance=True,
                                   telemetry=True, device="cpu")
    assert res["ok"], res.get("provenance", {}).get("check")
    tl = PO.run_timeline(res)
    _validate_against_golden(tl, json.load(open(GOLDEN)))
    flows = [e for e in tl["traceEvents"] if e["ph"] == "s"]
    assert flows and all(e["cat"] == "flow" for e in flows)
    ref = JN.run_broadcast_nemesis(JF.NemesisSpec(**kw), provenance=True,
                                   telemetry=True)
    assert tl == JO.run_timeline(ref)
    assert PO.run_timeline(res, name="x") == JO.run_timeline(ref, name="x")


def test_timeline_builder_events_equal_reference():
    pb, jb = PO.TimelineBuilder("t"), JO.TimelineBuilder("t")
    for b in (pb, jb):
        b.slice("a", "s", 0.0, 2.5, args={"k": 1})
        b.counter("c", "n", 1.0, 7)
        assert b.flow("v", "a", 0.5, "b", 3.25, args={"hop": 1}) == 1
        b.slice("b", "s2", 1.0, 1.0)
    assert pb.to_dict() == jb.to_dict()
    assert PO.add_provenance_flows(pb, {"arrival": np.array([[0], [2]]),
                                        "parent": np.array([[-1], [0]])}) \
        == JO.add_provenance_flows(jb, {"arrival": np.array([[0], [2]]),
                                        "parent": np.array([[-1], [0]])})
    assert pb.to_dict() == jb.to_dict()


def test_validate_timeline_rejects_acausal_flow():
    tb = PO.TimelineBuilder("bad")
    tb.slice("a", "x", 0.0, 1.0)
    tb.flow("v", "a", 5.0, "a", 1.0)     # finishes before it starts
    with pytest.raises(ValueError, match="causality"):
        PO.validate_timeline(tb.to_dict())
    tb2 = PO.TimelineBuilder("bad2")
    tb2.events.append({"ph": "s", "pid": 1, "tid": 1, "id": 9,
                       "name": "v", "ts": 0.0})
    with pytest.raises(ValueError, match="pair"):
        PO.validate_timeline(tb2.to_dict())
    for bad, msg in (({"schema": "x"}, "schema"),
                     ({"schema": PO.TIMELINE_SCHEMA, "traceEvents": []},
                      "no traceEvents"),
                     ({"schema": PO.TIMELINE_SCHEMA,
                       "traceEvents": [{"ph": "Q"}]}, "phase")):
        with pytest.raises(ValueError, match=msg):
            PO.validate_timeline(bad)


def test_bundle_write_is_atomic_and_loud(tmp_path):
    # tests/test_telemetry.py:392 on the port
    with pytest.raises(ValueError, match="kind"):
        PO.write_flight_bundle(str(tmp_path), kind="chaos",
                               workload="counter")
    p = PO.write_flight_bundle(
        str(tmp_path), kind="nemesis", workload="counter",
        nemesis={"seed": 9}, failure={"n_lost_writes": 1})
    assert json.load(open(p))["schema"] == PO.BUNDLE_SCHEMA
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    p2 = PO.write_flight_bundle(
        str(tmp_path), kind="nemesis", workload="counter",
        nemesis={"seed": 9}, failure={"n_lost_writes": 2})
    assert p2 != p
    assert json.load(open(p))["failure"]["n_lost_writes"] == 1
    assert json.load(open(p2))["failure"]["n_lost_writes"] == 2
    # the same file name and content as the reference writes
    q = JO.write_flight_bundle(str(tmp_path / "ref"), kind="nemesis",
                               workload="counter", nemesis={"seed": 9},
                               failure={"n_lost_writes": 1})
    assert os.path.basename(q) == os.path.basename(p)
    want, got = json.load(open(q)), json.load(open(p))
    want.pop("created_unix"), got.pop("created_unix")
    assert got == want
    with pytest.raises(ValueError, match="not a flight bundle"):
        PO.load_bundle({"schema": "nope"})
    # a failed write leaves no temporary file and no artifact
    with pytest.raises(TypeError):
        PO.write_json_atomic(str(tmp_path / "x.json"), {"a": object()})
    assert not os.path.exists(tmp_path / "x.json")
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_manifest_and_timeline_schemas():
    # tests/test_telemetry.py:416 on the port: a faulted Kafka serving
    # run's timeline tracks and its manifest
    spec = PF.NemesisSpec(n_nodes=8, seed=5, crash=((2, 5, (1, 4)),),
                          loss_rate=0.1, loss_until=6)
    tspec = PT.TrafficSpec(n_nodes=8, n_clients=8, ops_per_client=6,
                           until=10, rate=0.3, seed=2)
    res = PSV.run_serving("kafka", tspec, nemesis=spec, telemetry=True,
                          device="cpu")
    assert res["ok"], res.get("telemetry", {}).get("check")
    tl = PO.run_timeline(res)
    PO.validate_timeline(tl)
    names = {e.get("args", {}).get("name") for e in tl["traceEvents"]
             if e["ph"] == "M"}
    assert {"rounds", "faults", "traffic"} <= names
    counters = {e["name"] for e in tl["traceEvents"] if e["ph"] == "C"}
    assert "telemetry/arrived" in counters
    assert "telemetry/live_nodes" in counters
    crash = [e for e in tl["traceEvents"] if e["ph"] == "X"
             and e["name"].startswith("crash")]
    assert crash and crash[0]["dur"] == 3 * PO.US_PER_ROUND
    man = PO.run_manifest(res, programs={"observed-run":
                                         {"fingerprint": "0" * 16}})
    PO.validate_manifest(man)
    assert man["specs"]["telemetry"]["spec"]["workload"] == "kafka"
    assert man["verdict"]["ok"] is True
    assert man["env"]["torch"] == torch.__version__
    assert man["env"]["backend"] in ("cpu", "cuda")
    json.dumps(man)
    ref = JO.run_manifest(_jsonable(res))
    for key in ("config", "specs", "verdict", "timings", "workload"):
        assert _jsonable(man[key]) == _jsonable(ref[key]), key
    for bad, msg in (({"schema": "x"}, "schema"),
                     ({"schema": PO.MANIFEST_SCHEMA}, "missing"),
                     (dict(man, verdict={}), "ok"),
                     (dict(man, programs={"p": {}}), "fingerprint")):
        with pytest.raises(ValueError, match=msg):
            PO.validate_manifest(bad)


def test_profiled_writes_a_chrome_trace(tmp_path, monkeypatch):
    with PO.profiled(None) as d:
        assert d is None
    out = tmp_path / "prof"
    with PO.profiled(str(out)) as d:
        torch.ones(8).sum()
    assert d == str(out)
    [trace] = os.listdir(out)
    assert "traceEvents" in json.load(open(out / trace))
    # the serving runner's capture: GG_PROFILE_DIR
    monkeypatch.setenv("GG_PROFILE_DIR", str(tmp_path / "serving"))
    tspec = PT.TrafficSpec(n_nodes=8, n_clients=8, ops_per_client=4,
                           until=6, rate=0.3, seed=1)
    assert PSV.run_serving("counter", tspec, device="cpu")["ok"]
    assert len(os.listdir(tmp_path / "serving")) == 1


# -- the flight bundles, across packages ------------------------------------

SPEC = dict(n_nodes=12, seed=5, crash=((2, 6, (1, 7)),), loss_rate=0.15,
            loss_until=8)
TKW = dict(n_nodes=12, n_clients=12, ops_per_client=5, until=8, rate=0.3,
           seed=3)
# name -> (JAX runner, port runner, kwargs): each fails (a recovery budget
# too small to converge, or kv_amnesia) and records a series or stamps
BUNDLES = {
    "broadcast_gather_provenance": (
        JN.run_broadcast_nemesis, PN.run_broadcast_nemesis,
        dict(provenance=True, telemetry=True, max_recovery_rounds=0)),
    "broadcast_structured": (
        JN.run_broadcast_nemesis, PN.run_broadcast_nemesis,
        dict(topology="tree", structured=True, telemetry=True,
             max_recovery_rounds=0)),
    "counter": (JN.run_counter_nemesis, PN.run_counter_nemesis,
                dict(telemetry=True, provenance=True,
                     max_recovery_rounds=0)),
    "kafka": (JN.run_kafka_nemesis, PN.run_kafka_nemesis,
              dict(telemetry=True, provenance=True, max_recovery_rounds=0)),
    "txn": (JH.run_txn_nemesis, PH.run_txn_nemesis,
            dict(n_keys=8, until=10, kv_amnesia=True)),
    "serving": (JSV.run_serving, PSV.run_serving,
                dict(sim_kw={"mode": "allreduce"}, telemetry=True,
                     max_recovery_rounds=0)),
}


def _run(which: str, name: str, out, **extra):
    jrun, prun, kw = BUNDLES[name]
    spec = (JF if which == "jax" else PF).NemesisSpec(**SPEC)
    if which == "port":
        extra["device"] = "cpu"
    if name == "txn":
        # the owner of key 0 crashes (tests/test_txn.py:120)
        from gossip_glomers_tpu_torch.tpu_sim.kvstore import host_owner_of

        own = int(host_owner_of(np.zeros(1, np.int32), 12, 0)[0])
        meta = dict(SPEC, crash=((3, 6, (own,)),), loss_rate=0.0,
                    loss_until=None)
        spec = (JF if which == "jax" else PF).NemesisSpec(**meta)
    run = jrun if which == "jax" else prun
    if name == "serving":
        tr = (JT if which == "jax" else PT).TrafficSpec(**TKW)
        return run("counter", tr, nemesis=spec, observe_dir=str(out), **kw,
                   **extra)
    return run(spec, observe_dir=str(out), **kw, **extra)


def _verdict(res: dict) -> dict:
    keys = ("ok", "clear_round", "converged_round", "n_lost_writes",
            "msgs_total", "first_divergence_round")
    out = {k: res.get(k) for k in keys}
    if "serializability" in res:
        out["by_kind"] = res["serializability"]["by_kind"]
    out["series"] = (res.get("telemetry") or {}).get("series")
    out["stamps"] = (res.get("provenance") or {}).get("arrays")
    return _jsonable(out)


@pytest.mark.parametrize("name", sorted(BUNDLES))
@pytest.mark.parametrize("writer", ("jax", "port"))
def test_bundle_replays_in_the_other_package(name, writer, tmp_path):
    res = _run(writer, name, tmp_path)
    assert not res["ok"]
    path = res["flight_bundle"]
    replays = {"port": PO.replay_bundle(path, device="cpu"),
               "jax": JO.replay_bundle(path)}
    for who, rep in replays.items():
        assert not rep["ok"], who
        assert rep["first_divergence_round"] is None, who
    want = _verdict(dict(res, first_divergence_round=None))
    for who, rep in replays.items():
        got = _verdict(rep)
        for key in want:
            if key in ("series", "stamps") and want[key] is None:
                continue
            assert got[key] == want[key], (who, key)
    # the two packages write the same bundle for the same failure
    other = _run("port" if writer == "jax" else "jax", name,
                 tmp_path / "other")
    a, b = (PO.load_bundle(r["flight_bundle"]) for r in (res, other))
    for bundle in (a, b):
        bundle.pop("created_unix")
    assert _jsonable(a) == _jsonable(b)


def test_replay_bundle_refusals():
    with pytest.raises(NotImplementedError, match="item 10"):
        PO.replay_bundle({"schema": PO.BUNDLE_SCHEMA}, mesh=object())
    bundle = {"schema": PO.BUNDLE_SCHEMA, "kind": "serving",
              "workload": "counter"}
    with pytest.raises(ValueError, match="traffic spec"):
        PO.replay_bundle(bundle, device="cpu")
    with pytest.raises(ValueError, match="NemesisSpec"):
        PO.replay_bundle(dict(bundle, kind="nemesis"), device="cpu")
    # the frontier report's check is ported: it refuses a report that is
    # not one
    with pytest.raises(ValueError, match="frontier schema"):
        PO.validate_frontier({})


# -- BroadcastSim's host API ----------------------------------------------


@pytest.mark.parametrize("layout", ("gather", "words_major"))
def test_broadcast_host_api_equals_reference(layout):
    n, nv = 37, 40
    nbrs = to_padded_neighbors(tree(n))
    inj = JB.make_inject(n, nv)
    jkw, pkw = {}, {}
    if layout == "words_major":
        jkw["exchange"] = JS.make_exchange("tree", n)
        pkw["exchange"] = PS.make_exchange("tree", n)
    js = JB.BroadcastSim(nbrs, n_values=nv, sync_every=3, **jkw)
    ps = PB.BroadcastSim(nbrs, n_values=nv, sync_every=3, device="cpu",
                         **pkw)
    jst, jrounds, jstats = js.run_stats(inj)
    pst, prounds, pstats = ps.run_stats(inj)
    assert (prounds, pstats) == (jrounds, jstats)
    assert ps.read(pst) == js.read(jst)
    for max_rounds in (2, 1 << 16):
        staged, target = ps.stage(inj)
        got = ps.run_staged(staged, target, max_rounds=max_rounds)
        want = js.run_staged(*js.stage(inj), max_rounds=max_rounds)
        assert got.t == int(want.t) and int(got.msgs) == int(want.msgs)
        np.testing.assert_array_equal(ps.received_node_major(got),
                                      js.received_node_major(want))
        assert ps.read(got) == js.read(want)
        assert staged.t == 0            # the staged state stays reusable
    if layout == "words_major":
        with pytest.raises(ValueError, match="gather path"):
            ps.inject_mid(pst, 0, 0)
        return
    for node, value in ((5, 39), (0, 31), (36, 0)):
        jst, pst = js.inject_mid(jst, node, value), \
            ps.inject_mid(pst, node, value)
        np.testing.assert_array_equal(ps.received_node_major(pst),
                                      js.received_node_major(jst))
        assert int(pst.srv_msgs) == int(jst.srv_msgs)
        jst, pst = js.step(jst), ps.step(pst)
        assert ps.read(pst) == js.read(jst)
        assert int(pst.msgs) == int(jst.msgs)
    # the ledger-off sim skips the origin's charge
    quiet = PB.BroadcastSim(nbrs, n_values=nv, srv_ledger=False,
                            device="cpu")
    st = quiet.inject_mid(quiet.init_state(inj), 3, 7)
    assert st.srv_msgs is None and 7 in quiet.read(st)[3]
