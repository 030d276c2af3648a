"""The fault-space fuzzer on PyTorch against the reference, on the CPU,
tolerance 0: the sampler (every workload and axis), the failure
signatures and weights, the shrinker end to end
(tests/test_scenario.py:313-355, the same seeds) with its bundle
replayed in both packages, the delayed repro (:491), ``fuzz_run``
(rows, verdicts, shrunk scenarios, coverage) with shape buckets,
pipelining, signatures, adaptive steering and the membership axis
(tests/test_frontier.py:296-336, tests/test_membership.py:424-471),
and the refusals; ``mesh=`` raises Queue A item 10.

``fuzz_run``'s wall-clock fields (``WALL``) and the shrink records'
bundle paths are removed before a result is compared."""

import numpy as np
import pytest

from gossip_glomers_tpu.harness import fuzz as JFZ
from gossip_glomers_tpu.harness import observe as JO
from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import scenario as JSC
from gossip_glomers_tpu_torch.harness import fuzz as PFZ
from gossip_glomers_tpu_torch.harness import nemesis as PNM
from gossip_glomers_tpu_torch.harness import observe as PO
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import scenario as PSC

WALL = ("batch_walls_s", "sample_s", "dispatch_s", "total_s",
        "scenarios_per_sec", "scenarios_per_sec_steady")
FUZZ_KW = dict(workload="broadcast", n_scenarios=8, n_nodes=12,
               batch_size=4, horizon=6, max_recovery_rounds=16, seed=7,
               shrink=False)


def strip(res: dict) -> dict:
    out = {k: v for k, v in res.items() if k not in WALL}
    out["shrinks"] = [{k: v for k, v in s.items() if k != "bundle"}
                      for s in res.get("shrinks", ())]
    return out


def metas(cells) -> list:
    return [sc.to_meta() for sc in cells]


# -- the sampler ---------------------------------------------------------


@pytest.mark.parametrize("workload,kw", [
    ("broadcast", {}),
    ("broadcast", {"delay_axis": True, "nbrs_shape": (16, 4)}),
    ("broadcast", {"membership_axis": True}),
    ("counter", {}), ("counter", {"membership_axis": True}),
    ("kafka", {"membership_axis": True}), ("txn", {}),
])
def test_sampler_matches_reference(workload, kw):
    a = PFZ.sample_scenarios(workload, 24, n_nodes=16, seed=9, horizon=8,
                             **kw)
    assert metas(a) == metas(JFZ.sample_scenarios(
        workload, 24, n_nodes=16, seed=9, horizon=8, **kw))
    assert metas(a) == metas(PFZ.sample_scenarios(
        workload, 24, n_nodes=16, seed=9, horizon=8, **kw))
    assert metas(a) != metas(PFZ.sample_scenarios(
        workload, 24, n_nodes=16, seed=10, horizon=8, **kw))
    assert [PFZ._axis_key(sc) for sc in a] == [
        JFZ._axis_key(JSC.Scenario.from_meta(m)) for m in metas(a)]
    if kw.get("membership_axis"):
        churn = [sc for sc in a if sc.spec.has_membership]
        assert churn and len(churn) < len(a)
        for sc in a:
            crash = {i for _s, _e, ns in sc.spec.crash for i in ns}
            for _r, ns in sc.spec.join + sc.spec.leave:
                assert not set(ns) & crash


def test_sampler_refusals_match_reference():
    for fn in (PFZ.sample_scenarios, JFZ.sample_scenarios):
        with pytest.raises(ValueError, match="txn"):
            fn("txn", 4, n_nodes=10, seed=1, horizon=6,
               membership_axis=True)
        with pytest.raises(ValueError, match="nbrs_shape"):
            fn("broadcast", 4, n_nodes=10, seed=1, horizon=6,
               delay_axis=True)
    for fn in (PFZ.planted_failure, JFZ.planted_failure):
        with pytest.raises(ValueError, match="planted-failure"):
            fn("kafka", 8, 6)


def test_axis_key_and_shrinker_moves_match_reference():
    kw = dict(n_nodes=12, seed=1, crash=((2, 5, (1, 3)), (6, 9, (4,))),
              loss_rate=0.1, dup_rate=0.05, join=((3, (8, 9, 10)),),
              leave=((20, (0, 4)),))
    parts = {"starts": [1, 4], "ends": [3, 6],
             "group": [[i % 2 for i in range(12)]] * 2}
    delays = tuple(tuple((i + j) % 2 + 1 for j in range(3))
                   for i in range(12))
    psc = PSC.Scenario(spec=PF.NemesisSpec(**kw), parts=parts,
                       delays=delays)
    jsc = JSC.Scenario(spec=JF.NemesisSpec(**kw), parts=parts,
                       delays=delays)
    assert PFZ._axis_key(psc) == JFZ._axis_key(jsc)
    assert len(PFZ._axis_key(psc)) == 9 and PFZ._axis_key(psc)[-2:] == \
        (3, 2)
    got = [(d, c.to_meta()) for d, c in PFZ._shrink_moves(psc)]
    want = [(d, c.to_meta()) for d, c in JFZ._shrink_moves(jsc)]
    assert got == want
    assert [d for d, _ in PFZ._components(psc)] == \
        [d for d, _ in JFZ._components(jsc)]
    w0 = PFZ.scenario_weight(psc)
    assert w0 == JFZ.scenario_weight(jsc)
    for desc, red in PFZ._shrink_moves(psc):
        red.spec.compile("cpu")
        # a halved rate keeps its weight; every other move sheds some
        assert PFZ.scenario_weight(red) <= w0, desc
        if not desc.startswith("halve loss") and \
                not desc.startswith("halve dup"):
            assert PFZ.scenario_weight(red) < w0, desc


def test_failure_signature_and_weight():
    # tests/test_scenario.py:357-372
    assert PFZ.failure_signature({"ok": True}) is None
    res = {"ok": False, "workload": "broadcast", "converged_round": None,
           "n_lost_writes": 2, "lost_writes": [5, 29]}
    sig = PFZ.failure_signature(res)
    assert sig == JFZ.failure_signature(res)
    assert sig == PFZ.failure_signature(dict(res, lost_writes=[29, 5]))
    nested = dict(res, lost_writes=[(3, 1), {"lost_sum": 4}])
    assert PFZ.failure_signature(nested) == JFZ.failure_signature(nested)
    heavy = PFZ.planted_failure("broadcast", 16, 8)
    light = PSC.Scenario(spec=PF.NemesisSpec(n_nodes=16, seed=0,
                                             crash=((0, 1, (0,)),)))
    assert PFZ.scenario_weight(heavy) > PFZ.scenario_weight(light)
    for wl in ("broadcast", "counter"):
        assert PFZ.planted_failure(wl, 16, 8).to_meta() == \
            JFZ.planted_failure(wl, 16, 8).to_meta()


# -- the shrinker --------------------------------------------------------


def test_shrinker_minimal_repro_matches_reference(tmp_path):
    # tests/test_scenario.py:313-343, both packages, the same seeds; the
    # shrunk bundle replays to the same failure in each package
    n = 16
    kw = {"n_values": 2 * n, "topology": "grid", "sync_every": 4}
    rec = PFZ.shrink_scenario("broadcast", PFZ.planted_failure(
        "broadcast", n, 6), kw, 32, observe_dir=str(tmp_path / "p"),
        tel_rounds=40, device="cpu")
    want = JFZ.shrink_scenario("broadcast", JFZ.planted_failure(
        "broadcast", n, 6), kw, 32, observe_dir=str(tmp_path / "j"),
        tel_rounds=40)
    assert {k: v for k, v in rec.items() if k != "bundle"} == \
        {k: v for k, v in want.items() if k != "bundle"}
    assert rec["weight_after"] < rec["weight_before"]
    assert rec["moves_accepted"] and rec["all_components_load_bearing"]
    assert rec["replay_same_failure"]
    shrunk = rec["shrunk"]["spec"]
    assert shrunk["loss_rate"] == 0.0 and shrunk["dup_rate"] == 0.0
    assert rec["shrunk"]["parts"] is None
    assert len(shrunk["crash"]) == 1 and shrunk["crash"][0][0] == 0
    sig = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in rec["signature"].items()}
    for replay in (PO.replay_bundle(rec["bundle"], device="cpu"),
                   JO.replay_bundle(rec["bundle"]),
                   PO.replay_bundle(want["bundle"], device="cpu")):
        assert not replay["ok"]
        assert replay["first_divergence_round"] is None
        assert PFZ.failure_signature(replay) == sig


def test_shrinker_rejects_passing_scenario(tmp_path):
    sc = PSC.Scenario(spec=PF.NemesisSpec(n_nodes=16, seed=1,
                                          loss_rate=0.05, loss_until=4))
    with pytest.raises(ValueError, match="FAILING"):
        PFZ.shrink_scenario("broadcast", sc,
                            {"n_values": 32, "topology": "grid",
                             "sync_every": 4}, 32,
                            observe_dir=str(tmp_path), tel_rounds=36,
                            device="cpu")


def test_delayed_repro_bundle_replays_in_both_packages(tmp_path):
    # tests/test_scenario.py:491-513: the fuzzer's delayed-scenario repro
    # path, per-edge gather delays through run_broadcast_nemesis
    n = 16
    sc = PFZ.planted_failure("broadcast", n, 8)
    nbrs = jtop.to_padded_neighbors(jtop.grid(n))
    delays = np.random.default_rng(3).integers(1, 3, nbrs.shape).astype(
        np.int32)
    res = PNM.run_broadcast_nemesis(
        sc.spec, topology="grid", parts=sc.parts, delays=delays,
        telemetry=True, observe_dir=str(tmp_path), device="cpu")
    assert not res["ok"]
    bundle = PO.load_bundle(res["flight_bundle"])
    assert bundle["runner_kw"]["delays"] == delays.tolist()
    for replay in (PO.replay_bundle(res["flight_bundle"], device="cpu"),
                   JO.replay_bundle(res["flight_bundle"])):
        assert not replay["ok"]
        assert replay["lost_writes"] == res["lost_writes"]
        assert replay["first_divergence_round"] is None
    seq = PFZ.run_sequential(
        "broadcast", PSC.Scenario(spec=sc.spec, parts=sc.parts,
                                  delays=tuple(map(tuple, delays))),
        {"topology": "grid"}, 96, device="cpu")
    assert seq["lost_writes"] == res["lost_writes"]


# -- fuzz_run ------------------------------------------------------------


def test_fuzz_shape_buckets_and_pipeline_match_reference():
    # tests/test_frontier.py:304-323
    base = PFZ.fuzz_run(**FUZZ_KW, device="cpu")
    buck = PFZ.fuzz_run(**FUZZ_KW, shape_buckets=True, pipeline=True,
                        signatures=True, device="cpu")
    assert strip(buck) == strip(JFZ.fuzz_run(
        **FUZZ_KW, shape_buckets=True, pipeline=True, signatures=True))
    assert strip(base) == strip(JFZ.fuzz_run(**FUZZ_KW))
    for a, b in zip(base["rows"], buck["rows"]):
        for k in ("ok", "spec", "parts", "delays", "converged_round",
                  "n_lost"):
            assert a.get(k) == b.get(k), k
        assert len(b["signature"]) == 5
    assert buck["n_program_shapes"] <= base["n_program_shapes"]
    assert buck["shape_knobs"]["pad_to"] == 4
    assert buck["coverage"]["n_seen"] == len(buck["rows"])
    sync = PFZ.fuzz_run(**FUZZ_KW, shape_buckets=True, signatures=True,
                        device="cpu")
    assert [r["signature"] for r in sync["rows"]] == \
        [r["signature"] for r in buck["rows"]]


def test_fuzz_adapt_matches_reference_and_is_guarded():
    # tests/test_frontier.py:326-336
    kw = dict(FUZZ_KW, workload="counter", n_scenarios=8)
    a1 = PFZ.fuzz_run(**kw, adapt=True, device="cpu")
    assert strip(a1) == strip(JFZ.fuzz_run(**kw, adapt=True))
    a2 = PFZ.fuzz_run(**kw, adapt=True, device="cpu")
    assert a1["coverage"]["signatures"] == a2["coverage"]["signatures"]
    assert a1["adapt"] and a1["n_distinct_signatures"] >= 1
    assert sum(r["n_samples"] for r in a1["coverage"]["axes"]) == 8
    with pytest.raises(ValueError, match="incompatible"):
        PFZ.fuzz_run(**kw, adapt=True, pipeline=True, device="cpu")
    with pytest.raises(ValueError, match="signatures/adapt"):
        PFZ.fuzz_run("txn", 4, signatures=True, device="cpu")
    with pytest.raises(ValueError, match="unknown fuzz workload"):
        PFZ.fuzz_run("echo", 4, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        PFZ.fuzz_run(**FUZZ_KW, mesh=object(), device="cpu")


def test_fuzz_planted_failure_shrinks_as_the_reference(tmp_path):
    # fault_sweep.py's --fuzz shape, cut to 16 scenarios: the planted
    # cell fails, is named, shrinks to the reference's scenario, and its
    # repro's bundle replays in both packages
    kw = dict(workload="broadcast", n_scenarios=16, n_nodes=12,
              batch_size=8, horizon=6, max_recovery_rounds=16, seed=7,
              plant_failure=True, max_shrinks=1)
    got = PFZ.fuzz_run(**kw, observe_dir=str(tmp_path / "p"), device="cpu")
    want = JFZ.fuzz_run(**kw, observe_dir=str(tmp_path / "j"))
    assert strip(got) == strip(want)
    assert got["failing"][0]["index"] == 0
    assert got["failing"][0]["scenario"]["spec"]["seed"] == 424242
    rec = got["shrinks"][0]
    assert rec["replay_same_failure"] and \
        rec["weight_after"] < rec["weight_before"]
    assert not JO.replay_bundle(rec["bundle"])["ok"]


@pytest.mark.parametrize("workload,kw", [
    ("counter", dict(n_scenarios=12, n_nodes=10, batch_size=8,
                     membership_axis=True, signatures=True)),
    ("kafka", dict(n_scenarios=6, n_nodes=8, batch_size=4,
                   runner_kw={"n_keys": 4, "capacity": 64, "max_sends": 2,
                              "resync_every": 4, "send_prob": 0.7})),
    ("txn", dict(n_scenarios=4, n_nodes=8, batch_size=4,
                 runner_kw={"n_keys": 4, "until": 8})),
])
def test_fuzz_workloads_match_reference(workload, kw):
    common = dict(horizon=6, max_recovery_rounds=24, seed=3, shrink=False)
    got = PFZ.fuzz_run(workload, **kw, **common, device="cpu")
    assert strip(got) == strip(JFZ.fuzz_run(workload, **kw, **common))
    assert got["n_scenarios"] == kw["n_scenarios"]
