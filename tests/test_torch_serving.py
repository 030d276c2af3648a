"""The serving runner, its checkers and the telemetry ring on PyTorch
(gossip_glomers_tpu_torch/harness/serving.py, checkers.py and
tpu_sim/telemetry.py) against the JAX reference on the CPU: ``run_serving``
and ``run_serving_curve`` rows equal the reference's on every field that
is not wall-clock, for all three workloads, fault-free and under the
crash + loss overlay; each copied checker equals the original on seeded
inputs; and the telemetry spec, ring, subset, signature, env-knob and
falsifiability contracts of the reference's tests hold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import checkers as JCK
from gossip_glomers_tpu.harness import observe as JOB
from gossip_glomers_tpu.harness import serving as JSV
from gossip_glomers_tpu.tpu_sim import telemetry as JTM
from gossip_glomers_tpu.tpu_sim.faults import NemesisSpec as JN
from gossip_glomers_tpu.tpu_sim.traffic import TrafficSpec as JTS
from gossip_glomers_tpu_torch.harness import checkers as PCK
from gossip_glomers_tpu_torch.harness import serving as PSV
from gossip_glomers_tpu_torch.tpu_sim import telemetry as PTM
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT
from gossip_glomers_tpu_torch.tpu_sim.counter import CounterSim as PC
from gossip_glomers_tpu_torch.tpu_sim.faults import NemesisSpec as PN
from gossip_glomers_tpu_torch.tpu_sim.traffic import TrafficSpec as PTS

N = 64
WALL = ("driven_s", "total_s", "ops_per_sec")


def spec_kw(**kw):
    base = dict(n_nodes=N, n_clients=64, ops_per_client=8, until=16,
                rate=0.2, seed=108)
    base.update(kw)
    return base


def overlay_kw():
    # serving_curve.py's overlay law: every fifth node down for the
    # middle third of the horizon, loss 0.1 until four rounds after it
    return dict(n_nodes=N, seed=107, crash=((5, 10, tuple(range(0, N, 5))),),
                loss_rate=0.1, loss_until=14)


def assert_rows(a: dict, b: dict) -> None:
    assert set(a) == set(b), set(a) ^ set(b)
    for k in set(a) - set(WALL):
        assert a[k] == b[k], (k, a[k], b[k])


SERVING_CASES = {
    "broadcast_tree": ("broadcast", dict(topology="tree", structured=True,
                                         sync_every=4), False),
    "broadcast_grid_overlay": ("broadcast", dict(topology="grid",
                                                 structured=True,
                                                 sync_every=4), True),
    "broadcast_gather_overlay": ("broadcast", dict(topology="grid"), True),
    "broadcast_dir_delays": ("broadcast", dict(
        topology="tree", structured=True, dir_delays=(1, 2)), False),
    "counter_allreduce_overlay": ("counter", dict(mode="allreduce",
                                                  poll_every=2), True),
    "counter_cas": ("counter", dict(mode="cas", poll_every=2), False),
    "kafka_overlay": ("kafka", dict(n_keys=16, max_sends=4,
                                    resync_every=4), True),
    "kafka_blocked_overlay": ("kafka", dict(n_keys=16, max_sends=4,
                                            union_block=16), True),
}


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_run_serving_matches_reference(case):
    kind, sim_kw, overlay = SERVING_CASES[case]
    rows = []
    for mod, spec_cls, nem_cls, extra in (
            (JSV, JTS, JN, {}), (PSV, PTS, PN, {"device": "cpu"})):
        rows.append(mod.run_serving(
            kind, spec_cls(**spec_kw()),
            nemesis=nem_cls(**overlay_kw()) if overlay else None,
            sim_kw=dict(sim_kw), series=True, telemetry=True,
            max_recovery_rounds=64, **extra))
    assert_rows(*rows)
    assert rows[1]["telemetry"]["check"]["problems"] == []
    if kind != "counter" or not overlay:
        assert rows[1]["ok"] and rows[1]["n_lost_writes"] == 0


@pytest.mark.parametrize("kind,sim_kw,loads", [
    ("kafka", dict(n_keys=16, max_sends=4), (0.1, 0.3)),
    ("counter", dict(mode="cas", poll_every=2), (0.5 / N, 2.0 / N)),
    ("broadcast", dict(topology="tree", structured=True), (0.05, 0.5))])
def test_run_serving_curve_matches_reference(kind, sim_kw, loads):
    kw = spec_kw(until=12)
    a = JSV.run_serving_curve(kind, JTS(**kw), list(loads),
                              sim_kw=dict(sim_kw), max_recovery_rounds=128,
                              latency_bound={"p99_max_rounds": 64})
    b = PSV.run_serving_curve(kind, PTS(**kw), list(loads),
                              sim_kw=dict(sim_kw), max_recovery_rounds=128,
                              latency_bound={"p99_max_rounds": 64},
                              device="cpu")
    assert [r["traffic"]["rate"] for r in b] == list(loads)
    for ra, rb in zip(a, b):
        assert_rows(ra, rb)
        assert rb["ok"] and rb["conserved"] and rb["in_flight"] == 0


@pytest.mark.parametrize("kind,sim_kw", [
    ("broadcast", dict(topology="tree", structured=True)),
    ("broadcast", dict(topology="grid", n_values=1024)),
    ("kafka", dict(n_keys=8)),
    ("kafka", dict(n_keys=4, capacity=96)),
    ("counter", dict(mode="allreduce"))])
def test_serving_widths_are_the_built_sims(kind, sim_kw):
    # the widths serving_widths reports are the ones make_serving_sim
    # builds, here and in the reference
    kw = spec_kw(rate=0.35)
    widths = PSV.serving_widths(kind, PTS(**kw), dict(sim_kw))
    psim, _ = PSV.make_serving_sim(kind, PTS(**kw), device="cpu",
                                   **dict(sim_kw))
    jsim, _ = JSV.make_serving_sim(kind, JTS(**kw), **dict(sim_kw))
    for key, value in widths.items():
        assert getattr(psim, key) == getattr(jsim, key) == value, key
    assert widths or kind == "counter"


def test_counter_cas_latency_grows_at_saturation():
    lo = PSV.run_serving("counter", PTS(**spec_kw(rate=0.1, until=16)),
                         sim_kw={"mode": "cas"}, device="cpu")
    hi = PSV.run_serving("counter", PTS(**spec_kw(rate=1.0, until=16)),
                         sim_kw={"mode": "cas"}, device="cpu",
                         max_recovery_rounds=1024)
    assert lo["ok"] and hi["ok"]
    assert hi["lat_p50"] > lo["lat_p50"] and hi["lat_p99"] > lo["lat_p99"]


def test_serving_unported_and_default_device(monkeypatch, tmp_path):
    spec = PTS(**spec_kw())
    for fn in (
            lambda: PSV.run_serving("counter", spec, mesh=object(),
                                    device="cpu"),
            lambda: PSV.make_serving_sim("counter", spec, mesh=object()),
            lambda: PSV.run_serving_curve("counter", spec, [0.1],
                                          mesh=object())):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn()
    # the flight bundle and the profiler capture run: a failed run (no
    # drain budget) writes its bundle, a passing one none, and
    # GG_PROFILE_DIR leaves the driven phase's Chrome trace
    bad = PSV.run_serving("counter", spec, observe_dir=str(tmp_path / "b"),
                          max_recovery_rounds=0, device="cpu")
    assert not bad["ok"]
    bundle = JOB.load_bundle(bad["flight_bundle"])
    assert bundle["kind"] == "serving" and bundle["traffic"] \
        == spec.to_meta()
    monkeypatch.setenv("GG_PROFILE_DIR", str(tmp_path / "p"))
    good = PSV.run_serving("counter", spec, observe_dir=str(tmp_path / "g"),
                           device="cpu")
    assert good["ok"] and "flight_bundle" not in good
    assert not (tmp_path / "g").exists()
    assert len(list((tmp_path / "p").iterdir())) == 1
    monkeypatch.delenv("GG_PROFILE_DIR")
    with pytest.raises(ValueError, match="unknown serving workload"):
        PSV.make_serving_sim("queue", spec, device="cpu")
    with pytest.raises(ValueError, match="membership"):
        PSV.run_serving("counter", spec, device="cpu", nemesis=PN(
            n_nodes=N, join=((2, (3,)),)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSV.run_serving("counter", spec)


# -- the copied checkers --------------------------------------------------


def _rand_series(rng, rounds: int, wrong: bool) -> dict:
    arr = np.cumsum(rng.integers(0, 5, rounds)).tolist()
    dfr = np.cumsum(rng.integers(0, 2, rounds)).tolist()
    iss = [a - d for a, d in zip(arr, dfr)]
    if wrong:
        iss[rng.integers(0, rounds)] += 1
    msgs = np.cumsum(rng.integers(0, 9, rounds)).tolist()
    if wrong and rng.random() < 0.5:
        msgs[-1] = msgs[0] - 1
    return {"_round": list(range(rounds)), "_wrapped": False,
            "msgs": msgs, "arrived": arr, "issued": iss, "deferred": dfr,
            "completed": sorted(rng.integers(0, max(1, iss[-1]), rounds)
                                .tolist())}


def test_checkers_match_reference():
    rng = np.random.default_rng(11)
    for i in range(60):
        wrong = bool(i % 3 == 0)
        conv = None if i % 7 == 0 else int(rng.integers(4, 40))
        kw = dict(clear_round=4, converged_round=conv,
                  max_recovery_rounds=int(rng.integers(8, 32)),
                  lost_writes=[{"open_ops": 1}] if i % 5 == 0 else [],
                  msgs_at_clear=int(rng.integers(0, 100)),
                  msgs_at_converged=int(rng.integers(100, 200)),
                  latency={"lat_p50": 1.0, "lat_p99": 2.0, "lat_max": 3},
                  divergence=None if i % 4 else 7)
        assert PCK.check_recovery(**kw) == JCK.check_recovery(**kw)
        summ = {"completed": int(rng.integers(0, 3)),
                "conserved": bool(i % 6), "lat_p50": 1.0,
                "lat_p99": float(rng.integers(1, 20)),
                "lat_max": int(rng.integers(1, 40))}
        lkw = dict(p99_max_rounds=8, max_rounds=(30 if i % 2 else None),
                   min_completed=i % 2)
        assert PCK.check_op_latency(summ, **lkw) == \
            JCK.check_op_latency(summ, **lkw)
        series = _rand_series(rng, 6, wrong)
        other = _rand_series(rng, 6, False) if i % 4 == 0 else None
        tkw = dict(msgs_total=series["msgs"][-1] + (i % 2),
                   traffic={"arrived": series["arrived"][-1],
                            "deferred": series["deferred"][-1],
                            "completed": series["completed"][-1]},
                   expected=other)
        assert PCK.check_telemetry(series, **tkw) == \
            JCK.check_telemetry(series, **tkw)
        if other is not None:
            assert PCK.series_divergence_round(other, series) == \
                JCK.series_divergence_round(other, series)


def test_check_telemetry_is_falsifiable():
    series = {"_round": [0, 1], "msgs": [4, 8], "arrived": [2, 4],
              "issued": [1, 3], "deferred": [1, 1], "completed": [0, 2]}
    ok, _ = PCK.check_telemetry(series, msgs_total=8, traffic={
        "arrived": 4, "deferred": 1, "completed": 2})
    assert ok
    ok, det = PCK.check_telemetry({**series, "msgs": [4, 7]}, msgs_total=8)
    assert not ok and "msgs[-1]" in det["problems"][0]
    assert not PCK.check_telemetry({**series, "msgs": [9, 8]},
                                   msgs_total=8)[0]
    assert not PCK.check_telemetry({**series, "issued": [1, 2]},
                                   traffic={})[0]


# -- telemetry -----------------------------------------------------------


def test_telemetry_spec_validation_and_meta_roundtrip():
    spec = PTM.TelemetrySpec("counter", rounds=8,
                             series=("msgs", "live_nodes"))
    assert spec.series == ("live_nodes", "msgs")
    assert PTM.TelemetrySpec.from_meta(spec.to_meta()) == spec
    assert spec.width == len(PTM.SIM_SERIES["counter"])
    assert sum(spec.static_mask) == 2
    for wl in PTM.SIM_SERIES:
        for traffic in (False, True):
            j = JTM.TelemetrySpec(wl, rounds=3, traffic=traffic)
            p = PTM.TelemetrySpec(wl, rounds=3, traffic=traffic)
            assert (p.names, p.series, p.static_mask, p.to_meta()) == \
                (j.names, j.series, j.static_mask, j.to_meta())
    for kw in (dict(workload="counter", rounds=8, series=("frontier_bits",)),
               dict(workload="counter", rounds=0),
               dict(workload="queue", rounds=4)):
        msgs = []
        for mod in (JTM, PTM):
            with pytest.raises(ValueError) as e:
                mod.TelemetrySpec(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_ring_records_wraps_and_reads_like_reference():
    spec = PTM.TelemetrySpec("broadcast", rounds=4, traffic=True,
                             series=("msgs", "known_bits", "arrived"))
    jspec = JTM.TelemetrySpec("broadcast", rounds=4, traffic=True,
                              series=("msgs", "known_bits", "arrived"))
    rng = np.random.default_rng(3)
    ptel, jtel = PTM.init_state(spec, "cpu"), JTM.init_state(jspec)
    for t in range(10):
        vals = [int(v) for v in rng.integers(0, 2**32, spec.width)]
        ptel = PTM.record(ptel, t, [torch.tensor(v) if i % 2 else v
                                    for i, v in enumerate(vals)],
                          spec.static_mask)
        jtel = JTM.record(jtel, t, [jnp.uint32(v) for v in vals],
                          jspec.static_mask)
        assert (ptel.ring.numpy() == np.asarray(jtel.ring)).all()
    rows, first, wrapped = PTM.ring_rows(ptel, spec)
    assert wrapped and first == 6 and rows.shape[0] == 4
    assert PTM.series_arrays(ptel, spec) == JTM.series_arrays(jtel, jspec)
    ring = ptel.ring
    for col in range(spec.width):
        for conv in (-1, 2, 9):
            assert PTM.ring_stall_round(ring, ptel.wrote, col, conv) == \
                int(JTM.ring_stall_round(jtel.ring, jtel.wrote, col, conv))
        assert PTM.ring_progress_depth(ring, ptel.wrote, col) == \
            int(JTM.ring_progress_depth(jtel.ring, jtel.wrote, col))
    for x in (-1, 0, 1, 2, 3, 4, 7, 8, 1000, 1 << 20):
        assert PTM.log2_bucket(x) == int(JTM.log2_bucket(x))
    full = PTM.TelemetrySpec("kafka", rounds=4)
    assert PTM.signature_columns(full) == JTM.signature_columns(
        JTM.TelemetrySpec("kafka", rounds=4))
    with pytest.raises(ValueError, match="signatures"):
        PTM.signature_columns(spec.__class__("kafka", rounds=4,
                                             series=("msgs",)))


def test_live_count_matches_reference():
    kw = dict(n_nodes=16, seed=2, crash=((1, 4, (0, 3, 5)), (3, 6, (5, 9))))
    jplan = JN(**kw).compile()
    pplan = PN(**kw).compile(device="cpu")
    for t in range(8):
        assert int(PTM.live_count(pplan, t, 16)) == \
            int(JTM.live_count(jplan, t, 16))
    assert PTM.live_count(None, 0, 16) == 16


def test_series_subset_prunes_columns():
    n = 8
    sim = PC(n, mode="cas", poll_every=2, device="cpu")
    tspec = PTS(n_nodes=n, n_clients=8, ops_per_client=4, until=6,
                rate=0.5, seed=1)
    tsp = PTM.TelemetrySpec("counter", rounds=6, traffic=True,
                            series=("msgs", "pending_total", "issued"))
    _st, _ts, tel = sim.run_traffic(
        sim.init_state(), sim.traffic_state(tspec), tspec, 6, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    arrs = PTM.series_arrays(tel, tsp)
    assert set(a for a in arrs if not a.startswith("_")) == \
        {"msgs", "pending_total", "issued"}
    for name, keep in zip(tsp.names, tsp.static_mask):
        if not keep:
            assert (tel.ring[:, tsp.names.index(name)] == 0).all()


def test_traffic_telemetry_conservation():
    n = 8
    spec = PN(n_nodes=n, seed=5, crash=((3, 6, (2,)),), loss_rate=0.1,
              loss_until=8)
    tspec = PTS(n_nodes=n, n_clients=8, ops_per_client=6, until=12,
                rate=0.4, seed=1)
    sim = PC(n, mode="cas", poll_every=2, device="cpu",
             fault_plan=spec.compile(device="cpu"))
    plain = sim.run_traffic(sim.init_state(), sim.traffic_state(tspec),
                            tspec, 16, donate=True)
    tsp = PTM.TelemetrySpec("counter", rounds=16, traffic=True)
    st, ts, tel = sim.run_traffic(
        sim.init_state(), sim.traffic_state(tspec), tspec, 16, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    assert torch.equal(plain[0].pending, st.pending)
    assert all(torch.equal(a, b) for a, b in zip(plain[1], ts))
    arrs = PTM.series_arrays(tel, tsp)
    assert all(a == i + d for a, i, d in
               zip(arrs["arrived"], arrs["issued"], arrs["deferred"]))
    assert arrs["arrived"][-1] == int(ts.arrived)
    ok, det = PCK.check_telemetry(arrs, msgs_total=int(st.msgs),
                                  traffic=PT.latency_summary(ts))
    assert ok, det


def test_env_knobs_and_setup_match_reference(monkeypatch):
    monkeypatch.setenv("GG_TELEMETRY", "yes")
    with pytest.raises(ValueError, match="GG_TELEMETRY"):
        PTM.enabled()
    monkeypatch.setenv("GG_TELEMETRY", "2")
    with pytest.raises(ValueError, match="GG_TELEMETRY"):
        PTM.enabled()
    monkeypatch.setenv("GG_TELEMETRY", "1")
    assert PTM.enabled() is True
    assert PSV.telemetry_setup(None, "kafka", 9, True) == \
        PTM.TelemetrySpec("kafka", rounds=9, traffic=True)
    monkeypatch.delenv("GG_TELEMETRY")
    assert PTM.enabled() is False
    monkeypatch.setenv("GG_TELEMETRY_SERIES", "msgs,frontier_bits")
    assert PTM.env_series("broadcast") == ("msgs", "frontier_bits")
    with pytest.raises(ValueError, match="GG_TELEMETRY_SERIES"):
        PTM.env_series("counter")
    for args in (("broadcast", 5, True), ("broadcast", 0, False)):
        assert PSV.telemetry_setup(True, *args).to_meta() == \
            JOB.telemetry_setup(True, *args).to_meta()
    monkeypatch.setenv("GG_TELEMETRY_SERIES", " , ")
    with pytest.raises(ValueError, match="GG_TELEMETRY_SERIES"):
        PTM.env_series("counter")
    monkeypatch.delenv("GG_TELEMETRY_SERIES")
    assert PSV.telemetry_setup(False, "counter", 4) is None
    with pytest.raises(ValueError, match="does not match"):
        PSV.telemetry_setup(PTM.TelemetrySpec("counter", rounds=4),
                            "counter", 4, True)
