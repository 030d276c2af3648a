"""The serving frontier and the coverage map on PyTorch against the
reference, on the CPU, tolerance 0: tests/test_frontier.py:82-358 run
through both packages (the SLO certifier, grid staging, the frontier
runner's report, coverage determinism across batch shapes, pipelining
and ``GG_TRAFFIC_BLOCK``, the failing cell's bundle replayed in both
packages, the serving shrinker, the table and timeline artifacts, the
coverage map) with ``validate_frontier`` on every report.  The mesh
case becomes a check that ``mesh=`` raises Queue A item 10, the
contracts case one that the audit raises item 14.

``run_frontier``'s wall-clock fields (``WALL``) and the bundle paths are
removed before a report is compared."""

import dataclasses

import pytest

from gossip_glomers_tpu.harness import checkers as JC
from gossip_glomers_tpu.harness import frontier as JFR
from gossip_glomers_tpu.harness import fuzz as JFZ
from gossip_glomers_tpu.harness import observe as JO
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import scenario as JSC
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu_torch.harness import checkers as PC
from gossip_glomers_tpu_torch.harness import frontier as PFR
from gossip_glomers_tpu_torch.harness import fuzz as PFZ
from gossip_glomers_tpu_torch.harness import observe as PO
from gossip_glomers_tpu_torch.harness import serving as PSV
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import scenario as PSC
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT

WALL = ("dispatch_s", "batch_walls_s", "cells_per_sec")
PARITY_KEYS = ("arrived", "issued", "deferred", "completed",
               "in_flight", "conserved", "lat_p50", "lat_p99",
               "lat_max", "msgs_total", "total_rounds",
               "converged_round", "recovery_rounds", "ok")


def strip(rep: dict) -> dict:
    out = {k: v for k, v in rep.items() if k not in WALL}
    out["bundles"] = [{k: v for k, v in b.items() if k != "path"}
                      for b in rep["bundles"]]
    return out


def _passing_row(i):
    return {"cell": i, "coords": [i // 16, (i // 4) % 4, i % 4],
            "completed": 5, "conserved": True, "lat_p50": 2.0,
            "lat_p99": 3.0, "lat_max": 4, "in_flight": 0,
            "sustained_per_round": 0.5, "converged_round": 10,
            "recovery_rounds": 2}


def _tspec(mod, n=8, rate=0.3, seed=1, **kw):
    return mod.TrafficSpec(n_nodes=n, n_clients=n, ops_per_client=2,
                           until=8, rate=rate, seed=seed, **kw)


GRID = dict(n_nodes=8, rates=(0.3, 0.6),
            fault_levels=(None, {"n_crash_windows": 1, "loss_rate": 0.1}),
            until=8, seed=3)


def both_grids(workload="broadcast", **kw):
    kw = dict(GRID, **kw)
    return (JFR.frontier_grid(workload, **kw),
            PFR.frontier_grid(workload, **kw))


# -- the falsifiable SLO certifier ---------------------------------------


def test_check_frontier_batch_planted_p99_violation_matches_reference():
    rows = [_passing_row(i) for i in range(64)]
    slo = {"p99_max_rounds": 8.0}
    assert PC.check_frontier_batch(rows, slo) == \
        JC.check_frontier_batch(rows, slo)
    ok, det = PC.check_frontier_batch(rows, slo)
    assert ok and det["n_ok"] == 64
    rows[37]["lat_p99"] = 40.0
    ok, det = PC.check_frontier_batch(rows, slo)
    assert (ok, det) == JC.check_frontier_batch(rows, slo)
    assert not ok and det["failing"] == [37]
    assert "cell(2, 1, 1)" in det["problems"][0]
    assert "p99 latency 40.0" in det["problems"][0]
    assert PC.check_frontier_batch.__module__ == PC.__name__


def test_check_slo_every_bound_is_falsifiable():
    r = _passing_row(0)
    cases = [(r, {"p99_max_rounds": 8}), (r, {"p99_max_rounds": 2.5}),
             (r, {"max_rounds": 3}),
             (dict(r, completed=0), {"min_completed": 1}),
             (r, {"min_sustained": 0.9}), (dict(r, conserved=False), {}),
             (dict(r, converged_round=None, in_flight=3), {}),
             (dict(r, converged_round=None), {"require_converged": False}),
             (dict(r, recovery_rounds=30), {"max_recovery_rounds": 8}),
             (r, {"p99_max_rounds": 1, "coords": (9, 9, 9)})]
    oks = []
    for row, kw in cases:
        got = PC.check_slo(row, **kw)
        assert got == JC.check_slo(row, **kw)
        oks.append(got[0])
    assert oks == [True, False, False, False, False, False, False, True,
                   False, False]


# -- grid staging --------------------------------------------------------


def test_frontier_grid_matches_reference():
    j, p = both_grids(rates=(0.2, 0.4, 0.6), topologies=("grid", "tree"))
    assert [c.to_meta() for c in p] == [c.to_meta() for c in j]
    assert len(p) == 12 and p[0].coords == (0, 0, 0)
    assert p[-1].coords == (2, 1, 1)
    assert p[0].spec is None and p[2].spec is not None and p[2].spec.crash
    assert len({c.traffic.seed for c in p}) == len(p)
    assert len({c.spec.crash for c in p if c.spec is not None}) > 1
    z = PFR.frontier_grid("counter", n_nodes=8, rates=(0.3,),
                          fault_levels=({"n_crash_windows": 0},), until=8)
    assert z[0].spec is None
    spec = PF.NemesisSpec(n_nodes=8, seed=2, crash=((1, 3, (2,)),))
    assert PFR.frontier_grid("counter", n_nodes=8, rates=(0.3,),
                             fault_levels=(spec,), until=8)[0].spec is spec
    for mod in (PFR, JFR):
        with pytest.raises(ValueError, match="unknown fault level"):
            mod.frontier_grid("counter", n_nodes=8, rates=(0.3,),
                              fault_levels=("heavy",), until=8)


# -- the frontier runner -------------------------------------------------


@pytest.mark.parametrize("workload,runner_kw", [
    ("counter", {"mode": "cas", "poll_every": 2}),
    ("kafka", {"n_keys": 4, "capacity": 48, "max_sends": 4,
               "resync_every": 4})])
def test_frontier_counter_kafka_match_reference(workload, runner_kw):
    # tests/test_frontier.py:145-155's two cells as a frontier, each row
    # also equal to the port's sequential run_serving
    j, p = both_grids(workload, rates=(0.4, 0.6))
    kw = dict(runner_kw=runner_kw, slo={"p99_max_rounds": 6},
              max_recovery_rounds=16, drain_every=4)
    rep = PFR.run_frontier(workload, p[1:3], device="cpu", **kw)
    PO.validate_frontier(rep)
    assert strip(rep) == strip(JFR.run_frontier(workload, j[1:3], **kw))
    for c, row in zip(p[1:3], rep["cells"]):
        seq = PSV.run_serving(workload, c.traffic, nemesis=c.spec,
                              sim_kw=runner_kw, max_recovery_rounds=16,
                              drain_every=4, device="cpu")
        for k in PARITY_KEYS:
            assert seq.get(k) == row.get(k), k


def test_frontier_coverage_deterministic_across_batch_shapes(monkeypatch):
    # tests/test_frontier.py:213-245, and every report the reference's
    j, p = both_grids()
    kw = dict(slo={"min_completed": 1}, max_recovery_rounds=16,
              drain_every=4)
    rep1 = PFR.run_frontier("broadcast", p, batch_size=4, pipeline=False,
                            device="cpu", **kw)
    rep2 = PFR.run_frontier("broadcast", p, batch_size=2, pipeline=True,
                            device="cpu", **kw)
    assert strip(rep2) == strip(JFR.run_frontier(
        "broadcast", j, batch_size=2, pipeline=True, **kw))
    monkeypatch.setenv("GG_TRAFFIC_BLOCK", "2")
    rep3 = PFR.run_frontier("broadcast", p, batch_size=4, pipeline=False,
                            device="cpu", **kw)
    assert strip(rep3) == strip(JFR.run_frontier(
        "broadcast", j, batch_size=4, pipeline=False, **kw))
    monkeypatch.delenv("GG_TRAFFIC_BLOCK")
    for rep in (rep1, rep2, rep3):
        PO.validate_frontier(rep)
        JO.validate_frontier(rep)
    assert rep1["batch_sizes"] == [4] and rep2["batch_sizes"] == [2, 2]

    def cell_key(c):
        return {k: c.get(k) for k in ("coords", "ok", "slo_ok",
                                      "completed", "lat_p50", "lat_p99",
                                      "msgs_total", "signature")}

    for other in (rep2, rep3):
        assert [cell_key(c) for c in rep1["cells"]] == \
            [cell_key(c) for c in other["cells"]]
        assert rep1["coverage"]["signatures"] == \
            other["coverage"]["signatures"]
    tl = PFR.frontier_timeline(rep1)
    assert tl == JFR.frontier_timeline(rep1)
    PO.validate_timeline(tl)
    assert any(ev.get("name") == "coverage/distinct_behaviors"
               for ev in tl["traceEvents"])
    tbl = PFR.frontier_table(rep1)
    assert tbl == JFR.frontier_table(rep1)
    assert len(tbl) == 4 and all("lat_p99" in r for r in tbl)


def test_frontier_burst_pad_is_bit_identical():
    # tests/test_frontier.py:174-193: a burst axis padded to a bigger
    # bucket changes no row; a batch mixing static shapes is refused
    c = PSC.ServingCell(traffic=_tspec(PT, rate=0.4, seed=5,
                                       burst=((2, 5, 1.5),)))
    kw = dict(max_recovery_rounds=16, drain_every=4, signatures=False,
              device="cpu")
    base = PFR.run_frontier("broadcast", [c], **kw)
    padded = PFR.run_frontier("broadcast", [c], n_burst=4, **kw)
    assert strip(base) == strip(padded)
    assert base["coverage"] is None
    for mod in (PT, JT):
        with pytest.raises(ValueError, match="static shapes"):
            mod.batch_tplans([_tspec(mod), dataclasses.replace(
                _tspec(mod), ops_per_client=3)])
        with pytest.raises(ValueError, match="cannot pad"):
            mod.pad_tplan(_tspec(mod, burst=((1, 3, 1.5), (4, 6, 1.5))
                                 ).compile(), 1)


def test_frontier_planted_slo_failure_bundle_replays_in_both(tmp_path):
    # tests/test_frontier.py:248-271: the failing cells' bundles, written
    # by either package, replay to the same check_slo failure in both
    j, p = both_grids()
    kw = dict(slo={"p99_max_rounds": 1}, max_recovery_rounds=16,
              drain_every=4, pipeline=False)
    rep = PFR.run_frontier("broadcast", p[:2], device="cpu",
                           observe_dir=str(tmp_path / "p"), **kw)
    want = JFR.run_frontier("broadcast", j[:2],
                            observe_dir=str(tmp_path / "j"), **kw)
    PO.validate_frontier(rep)
    assert strip(rep) == strip(want)
    assert not rep["ok"] and rep["bundles"]
    for b, wb in zip(rep["bundles"], want["bundles"]):
        bundle = PO.load_bundle(b["path"])
        assert bundle["kind"] == "serving"
        assert bundle["failure"]["checker"] == "check_slo"
        assert bundle["failure"]["grid_coords"] == b["coords"]
        assert bundle["traffic"]["rate"] == p[b["cell"]].traffic.rate
        assert any(f"cell{tuple(b['coords'])!r}" in q
                   for q in bundle["failure"]["problems"])
        for path in (b["path"], wb["path"]):
            for replay in (PO.replay_bundle(path, device="cpu"),
                           JO.replay_bundle(path)):
                ok_r, _ = PC.check_slo(
                    replay, **bundle["failure"]["slo"],
                    coords=bundle["failure"]["grid_coords"])
                assert not ok_r
                assert replay.get("first_divergence_round") is None


def test_shrink_serving_cell_matches_reference(tmp_path):
    # tests/test_frontier.py:274-293
    kw = dict(n_nodes=8, crash=((2, 5, (1, 2)),), loss_rate=0.1,
              loss_until=6)
    cells = [mod.ServingCell(traffic=_tspec(tm, rate=0.8, seed=5,
                                            burst=((2, 6, 1.2),)),
                             spec=fm.NemesisSpec(**kw), coords=(1, 2, 0))
             for mod, tm, fm in ((PSC, PT, PF), (JSC, JT, JF))]
    args = dict(max_recovery_rounds=16, drain_every=4)
    rec = PFZ.shrink_serving_cell("broadcast", cells[0], {},
                                  {"p99_max_rounds": 1},
                                  observe_dir=str(tmp_path / "p"),
                                  device="cpu", **args)
    want = JFZ.shrink_serving_cell("broadcast", cells[1], {},
                                   {"p99_max_rounds": 1},
                                   observe_dir=str(tmp_path / "j"), **args)
    assert {k: v for k, v in rec.items() if k != "bundle"} == \
        {k: v for k, v in want.items() if k != "bundle"}
    assert "halve rate" in rec["moves_accepted"]
    assert rec["weight_after"] < rec["weight_before"]
    assert rec["signature"]["kinds"] == ["p99"]
    assert rec["replay_same_failure"]
    shrunk = PO.load_bundle(rec["bundle"])
    assert shrunk["failure"]["grid_coords"] == [1, 2, 0]
    assert shrunk["traffic"]["rate"] < cells[0].traffic.rate
    replay = JO.replay_bundle(rec["bundle"])
    replay["coords"] = [1, 2, 0]
    assert JFR.slo_signature(replay, {"p99_max_rounds": 1}) == \
        PFR.slo_signature(replay, {"p99_max_rounds": 1})
    assert PFR.slo_signature(replay, {"p99_max_rounds": 1})["kinds"] == \
        ("p99",)
    assert PFZ._serving_weight(cells[0]) == JFZ._serving_weight(cells[1])
    assert [d for d, _ in PFZ._serving_moves(cells[0])] == \
        [d for d, _ in JFZ._serving_moves(cells[1])]


# -- the coverage map, the refusals --------------------------------------


def test_coverage_map_matches_reference():
    maps = (PFR.CoverageMap(), JFR.CoverageMap())
    for cm in maps:
        assert cm.novelty((1, 0.1)) == 2.0
        assert cm.add([1, 2, 0, 3, 0], axis=(1, 0.1), meta={"cell": 0})
        assert not cm.add([1, 2, 0, 3, 0], axis=(1, 0.1))
        assert cm.add([2, 2, 1, 3, 0], axis=(2, 0.0))
        assert cm.n_distinct == 2 and cm.n_seen == 3
        assert cm.axis_behaviors((1, 0.1)) == 1
        assert cm.axis_samples((1, 0.1)) == 2
        assert cm.novelty((1, 0.1)) == 0.5
        assert cm.count([2, 2, 1, 3, 0]) == 1
    assert maps[0].to_meta() == maps[1].to_meta()
    meta = maps[0].to_meta()
    cm2 = PFR.CoverageMap.from_meta(meta)
    assert cm2.n_distinct == 2 and cm2.n_seen == 3
    assert cm2.to_meta()["signatures"] == meta["signatures"]
    with pytest.raises(ValueError, match="fields"):
        PFR.signature_key([1, 2, 3])


def test_frontier_refusals():
    _, p = both_grids()
    with pytest.raises(NotImplementedError, match="item 10"):
        PFR.run_frontier("broadcast", p, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="at least one cell"):
        PFR.run_frontier("broadcast", [], device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        PSC.audit_contracts()
    bad = {"schema": "gg-frontier/0"}
    for fn in (PO.validate_frontier, JO.validate_frontier):
        with pytest.raises(ValueError, match="frontier schema"):
            fn(bad)
