"""The open-loop traffic engine and its telemetry ring on PyTorch
(gossip_glomers_tpu_torch/tpu_sim/traffic.py, telemetry.py and the sims'
``run_traffic`` drivers) against the JAX reference on the CPU: the same
seeded specs and sim settings give equal tracker leaves, sim state and
telemetry rings at every round — BroadcastSim on both layouts, plain,
under a nemesis and with per-direction delays; CounterSim in both flush
modes under a plan with amnesia; KafkaSim's union and faulted unions —
plus the spec, coin, ring, env-knob and backpressure contracts of the
reference's own tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gossip_glomers_tpu.parallel.topology import (grid as jgrid,
                                                  to_padded_neighbors,
                                                  tree as jtree)
from gossip_glomers_tpu.tpu_sim import structured as JS
from gossip_glomers_tpu.tpu_sim import telemetry as JTM
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu.tpu_sim.broadcast import BroadcastSim as JB
from gossip_glomers_tpu.tpu_sim.counter import CounterSim as JC
from gossip_glomers_tpu.tpu_sim.counter import KVReach as JKR
from gossip_glomers_tpu.tpu_sim.faults import NemesisSpec as JN
from gossip_glomers_tpu.tpu_sim.kafka import KafkaSim as JK
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import structured as PS
from gossip_glomers_tpu_torch.tpu_sim import telemetry as PTM
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT
from gossip_glomers_tpu_torch.tpu_sim.broadcast import BroadcastSim as PB
from gossip_glomers_tpu_torch.tpu_sim.counter import CounterSim as PC
from gossip_glomers_tpu_torch.tpu_sim.counter import KVReach as PKR
from gossip_glomers_tpu_torch.tpu_sim.kafka import KafkaSim as PK

N = 64


def spec_kw(**kw):
    base = dict(n_nodes=N, n_clients=64, ops_per_client=4, until=10,
                rate=0.3, seed=3)
    base.update(kw)
    return base


def specs(**kw):
    kw = spec_kw(**kw)
    return JT.TrafficSpec(**kw), PT.TrafficSpec(**kw)


def nemeses(**kw):
    base = dict(n_nodes=N, seed=5, crash=((2, 6, (1, 9, 17, 40)),),
                loss_rate=0.2, loss_until=8)
    base.update(kw)
    return JN(**base), PF.NemesisSpec(**base)


def same(a, b) -> bool:
    """A JAX leaf equals a port leaf: uint32 arrays through their int32
    view when the port holds int32 words, as values when it holds int64
    (the counters, the ring)."""
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.uint32 and b.dtype == np.int32:
        a = a.view(np.int32)
    return a.shape == b.shape and bool((a.astype(np.int64)
                                        == b.astype(np.int64)).all())


def assert_ts(j, p):
    for f in JT.TrafficState._fields:
        assert same(getattr(j, f), getattr(p, f)), f


def assert_tel(j, p):
    assert same(j.ring, p.ring) and int(j.wrote) == p.wrote


# -- spec / plan / coins -------------------------------------------------


def test_spec_validation_and_meta_roundtrip():
    jspec, pspec = specs(burst=((2, 5, 2.0),), intake=2, kind="constant")
    assert PT.TrafficSpec.from_meta(pspec.to_meta()) == pspec
    assert pspec.to_meta() == jspec.to_meta()
    assert pspec.program_key == jspec.program_key
    assert pspec.with_rate(0.1).rate == 0.1
    bad = [dict(rate=1.5), dict(kind="pareto"), dict(n_nodes=6, n_clients=4),
           dict(rate=0.8, burst=((0, 4, 3.0),)), dict(burst=((4, 99, 2.0),)),
           dict(burst=((0, 6, 2.0), (4, 8, 2.0))), dict(ops_per_client=0),
           dict(until=0), dict(intake=-1), dict(n_clients=0)]
    for kw in bad:
        msgs = []
        for mod in (JT, PT):
            with pytest.raises(ValueError) as e:
                mod.TrafficSpec(**spec_kw(**kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw


@pytest.mark.parametrize("kind,burst,rate", [
    ("poisson", (), 0.3), ("constant", (), 0.3), ("poisson", (), 1.0),
    ("poisson", ((3, 6, 2.5),), 0.3), ("constant", ((1, 4, 2.0),), 0.05),
    ("constant", (), 0.77)])
def test_arrival_coins_match_reference(kind, burst, rate):
    jspec, pspec = specs(kind=kind, burst=burst, rate=rate,
                         seed=0xDEADBEEF12)
    jplan, pplan = jspec.compile(), pspec.compile()
    for f in JT.TrafficPlan._fields:
        assert same(getattr(jplan, f), getattr(pplan, f)), f
    ids = np.arange(pspec.n_clients)
    total = 0
    for t in range(-1, 13):                  # includes t outside [0, until)
        want = np.asarray(JT.arrive(jplan, t, ids))
        got = PT.arrive(pplan, t, torch.from_numpy(ids))
        assert (got.numpy() == want).all(), t
        assert (PT.host_arrivals(pspec, t) == JT.host_arrivals(jspec, t)
                ).all()
        total += int(want.sum())
    assert total > 0


def test_constant_rate_cadence():
    _, pspec = specs(kind="constant", rate=0.25, until=16)
    per_client = np.zeros(pspec.n_clients, int)
    for t in range(16):
        per_client += PT.host_arrivals(pspec, t)
    assert (np.abs(per_client - 4) <= 1).all(), per_client


@pytest.mark.parametrize("n_nodes,n_clients", [(64, 64), (16, 64),
                                               (64, 16), (64, 1)])
def test_client_maps_and_intake_rank_match_reference(n_nodes, n_clients):
    jspec, pspec = specs(n_nodes=n_nodes, n_clients=n_clients)
    assert (PT.client_nodes(pspec) == JT.client_nodes(jspec)).all()
    assert same(JT.local_node_cols(jspec, n_clients),
                PT.local_node_cols(pspec, n_clients))
    arr = np.random.default_rng(n_clients).random(n_clients) < 0.6
    cpn = pspec.clients_per_node
    assert same(JT.intake_rank(arr, cpn),
                PT.intake_rank(torch.from_numpy(arr), cpn))
    assert PT.offered_per_round(pspec) == JT.offered_per_round(jspec)
    b_j, b_p = specs(burst=((1, 5, 2.0),))
    assert PT.offered_per_round(b_p) == JT.offered_per_round(b_j)


def test_tracker_primitives_match_reference():
    # issue / record_aux / done_scan / tel_series / latency_summary /
    # per_round_series on seeded arrivals, slot exhaustion included
    jspec, pspec = specs(ops_per_client=2)
    jts = JT.init_state(jspec)
    pts = PT.init_state(pspec, device="cpu")
    rng = np.random.default_rng(4)
    ident = lambda x: x                                   # noqa: E731
    for t in range(6):
        arr = rng.random(64) < 0.7
        acc = rng.random(64) < 0.8
        vals = rng.integers(0, 50, 64).astype(np.int32)
        done = rng.random((64, 2)) < 0.5
        jts, jok, jk = JT.issue(jts, arr, acc, t, ident)
        pts, pok, pk = PT.issue(pts, torch.from_numpy(arr),
                                torch.from_numpy(acc), t)
        assert same(jok, pok) and same(jk, pk)
        jts = JT.record_aux(jts, jok, jk, vals)
        pts = PT.record_aux(pts, pok, pk, torch.from_numpy(vals))
        jts = JT.done_scan(jts, lambda lo, b: lax.dynamic_slice_in_dim(
            jnp.asarray(done), lo, b, 0), t + 1, ident, 16)
        pts = PT.done_scan(pts, lambda lo, b: torch.from_numpy(
            done[lo:lo + b]), t + 1, 16)
        assert_ts(jts, pts)
        for a, b in zip(JT.tel_series(jts, ident), PT.tel_series(pts)):
            assert int(a) == int(b)
    assert PT.latency_summary(pts) == JT.latency_summary(jts)
    assert PT.per_round_series(pts, 8) == JT.per_round_series(jts, 8)


def test_traffic_block_env_parsing_is_loud(monkeypatch):
    monkeypatch.setenv("GG_TRAFFIC_BLOCK", "banana")
    with pytest.raises(ValueError, match="GG_TRAFFIC_BLOCK"):
        PT.traffic_block(8)
    monkeypatch.setenv("GG_TRAFFIC_BLOCK", "3")
    with pytest.raises(ValueError, match="GG_TRAFFIC_BLOCK"):
        PT.traffic_block(8)
    _, pspec = specs()
    with pytest.raises(ValueError, match="GG_TRAFFIC_BLOCK"):
        PC(N, device="cpu").run_traffic(None, None, pspec, 1)
    monkeypatch.setenv("GG_TRAFFIC_BLOCK", "99")
    assert PT.traffic_block(8) == 8
    monkeypatch.setenv("GG_TRAFFIC_BLOCK", "4")
    assert PT.traffic_block(8) == 4


def test_unported_parts_raise_with_their_items():
    _, pspec = specs()
    for fn, item in ((PT.plan_specs, 10),
                     (lambda: PT.state_specs(True), 10),
                     (lambda: PT.init_state(pspec, mesh=object()), 10),
                     (PTM.state_specs, 10), (PTM.audit_contracts, 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()
    # the resizing intake gate is ported: every arrival deferred, counted
    ts, ok = PT.resizing_defer(PT.init_state(pspec, device="cpu"),
                               torch.ones(pspec.n_clients, dtype=torch.bool))
    assert not ok.any() and int(ts.deferred_resizing) == pspec.n_clients
    # the scenario batches' plan padding and stacking are ported
    assert len(PT.pad_tplan(pspec.compile(), 2).b_starts) == 2
    assert PT.batch_tplans([pspec, pspec]).rate_num.shape == (2,)


def test_tracker_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pspec = specs()
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.init_state(pspec)
    with pytest.raises(RuntimeError, match="CUDA"):
        PTM.init_state(PTM.TelemetrySpec("counter", rounds=4))


# -- per-round parity of the three drivers -------------------------------

BROADCAST_CASES = ("gather", "wm", "wm_nemesis", "wm_dir_delays",
                   "gather_nemesis", "wm_edge_delayed")


def broadcast_pair(case: str, nv: int = 256):
    jkw = dict(sync_every=4, srv_ledger=False)
    pkw = dict(jkw, device="cpu")
    if case.startswith("wm"):
        jkw["exchange"] = JS.make_exchange("tree", N)
        pkw["exchange"] = PS.make_exchange("tree", N)
    if case.endswith("nemesis"):
        jn, pn = nemeses(dup_rate=0.1, dup_until=8)
        jkw["fault_plan"] = jn.compile()
        pkw["fault_plan"] = pn.compile(device="cpu")
        if case.startswith("wm"):
            jkw["nemesis"] = JS.make_nemesis("tree", N, jn)
            pkw["nemesis"] = PS.make_nemesis("tree", N, pn, device="cpu")
    if case == "wm_dir_delays":
        jkw["delayed"] = JS.make_delayed("tree", N, (1, 3))
        pkw["delayed"] = PS.make_delayed("tree", N, (1, 3))
    if case == "wm_edge_delayed":
        rows = np.random.default_rng(2).choice([1, 2], (2, N)).astype(
            np.int32)
        jkw["edge_delayed"] = JS.make_edge_delayed("tree", N, rows)
        pkw["edge_delayed"] = PS.make_edge_delayed("tree", N, rows)
    nbrs = to_padded_neighbors(jtree(N))
    return JB(nbrs, n_values=nv, **jkw), PB(nbrs, n_values=nv, **pkw)


def drive_pair(jsim, psim, jspec, pspec, rounds, check, workload,
               tel_series=(), ring=8):
    """Both drivers a round at a time with the telemetry ring on, held
    equal after every round by ``check(jst, pst)``, trackers and rings
    too; returns the port's final (state, ts)."""
    jst, pst = jsim.init_state(), psim.init_state()
    jts, pts = jsim.traffic_state(jspec), psim.traffic_state(pspec)
    jtsp = JTM.TelemetrySpec(workload, rounds=ring, traffic=True,
                             series=tel_series)
    ptsp = PTM.TelemetrySpec(workload, rounds=ring, traffic=True,
                             series=tel_series)
    jtel, ptel = JTM.init_state(jtsp), PTM.init_state(ptsp, "cpu")
    for _ in range(rounds):
        jst, jts, jtel = jsim.run_traffic(jst, jts, jspec, 1, tel=jtel,
                                          tel_spec=jtsp)
        pst, pts, ptel = psim.run_traffic(pst, pts, pspec, 1, tel=ptel,
                                          tel_spec=ptsp)
        assert_ts(jts, pts)
        assert_tel(jtel, ptel)
        check(jst, pst)
    return pst, pts


@pytest.mark.parametrize("case", BROADCAST_CASES)
def test_broadcast_traffic_matches_reference(case):
    jsim, psim = broadcast_pair(case)
    z = np.zeros((N, 8), np.uint32)
    jsim.init_state = lambda f=jsim.init_state: f(z)
    psim.init_state = lambda f=psim.init_state: f(z)
    jspec, pspec = specs(intake=1 if case == "gather" else None)

    def check(j, p):
        assert j.t == p.t and int(j.msgs) == int(p.msgs)
        assert same(j.received, p.received) and same(j.frontier, p.frontier)

    _, pts = drive_pair(jsim, psim, jspec, pspec, 18, check, "broadcast")
    summ = PT.latency_summary(pts)
    assert summ["conserved"] and summ["completed"] > 0


@pytest.mark.parametrize("mode", ["cas", "allreduce"])
def test_counter_traffic_matches_reference(mode, monkeypatch):
    # a plan with amnesia rows, a KV window and the tracker in slabs
    monkeypatch.setenv("GG_TRAFFIC_BLOCK", "16")
    jspec, pspec = specs(ops_per_client=6, until=12, rate=0.4, seed=1)
    jn, pn = nemeses(crash=((2, 6, (1, 9)), (7, 9, (3, 40))))
    blocked = np.zeros((1, N), bool)
    blocked[0, ::7] = True
    jsched = JKR(jnp.asarray([3], jnp.int32), jnp.asarray([5], jnp.int32),
                 jnp.asarray(blocked))
    psched = PKR.from_numpy([3], [5], blocked)
    jsim = JC(N, mode=mode, poll_every=2, fault_plan=jn.compile(),
              kv_sched=jsched)
    psim = PC(N, mode=mode, poll_every=2, device="cpu", kv_sched=psched,
              fault_plan=pn.compile(device="cpu"))

    def check(j, p):
        for f in ("pending", "cached", "kv", "msgs"):
            assert same(getattr(j, f), getattr(p, f)), f
        assert int(j.t) == p.t

    _, pts = drive_pair(jsim, psim, jspec, pspec, 24, check, "counter",
                        ring=32)
    assert PT.latency_summary(pts)["conserved"]


@pytest.mark.parametrize("mode", ["union", "union_nem", "union_nem_block",
                                  "union_nem_push"])
def test_kafka_traffic_matches_reference(mode):
    jspec, pspec = specs(ops_per_client=6, until=12, rate=0.4, seed=1,
                         n_clients=128)
    kw = dict(capacity=64, max_sends=2, resync_every=2)
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if mode != "union":
        jn, pn = nemeses(crash=((2, 6, (1, 9)), (7, 9, (3,))),
                         loss_until=10)
        jkw["fault_plan"] = jn.compile()
        pkw["fault_plan"] = pn.compile(device="cpu")
        ub = 16 if mode == "union_nem_block" else "materialized"
        jkw["union_block"] = pkw["union_block"] = ub
        if mode == "union_nem_push":
            jkw["resync_mode"] = pkw["resync_mode"] = "push"
    jsim, psim = JK(N, 4, **jkw), PK(N, 4, **pkw)
    series = JTM.series_names("kafka", True) if mode == "union" else ()

    def check(j, p):
        for f in ("log_vals", "present", "kv_val", "local_committed",
                  "origin_bits", "msgs"):
            assert same(getattr(j, f), getattr(p, f)), f

    _, pts = drive_pair(jsim, psim, jspec, pspec, 20, check, "kafka",
                        tel_series=series, ring=32)
    summ = PT.latency_summary(pts)
    assert summ["conserved"] and summ["in_flight"] == 0


def test_fused_run_equals_stepwise_and_leaves_inputs():
    # n rounds in one call (donated) equal n calls of one round; an
    # undonated call leaves the state and tracker it was given as they
    # were; telemetry on or off gives the same state
    _, psim = broadcast_pair("wm_nemesis")
    _, pspec = specs()
    z = np.zeros((N, 8), np.uint32)
    st0, ts0 = psim.init_state(z), psim.traffic_state(pspec)
    keep = (st0.received.clone(), ts0.issue_round.clone())
    st1, ts1 = psim.run_traffic(st0, ts0, pspec, 12)
    assert torch.equal(st0.received, keep[0])
    assert torch.equal(ts0.issue_round, keep[1])
    st2, ts2 = psim.init_state(z), psim.traffic_state(pspec)
    for _ in range(12):
        st2, ts2 = psim.run_traffic(st2, ts2, pspec, 1, donate=True)
    tsp = PTM.TelemetrySpec("broadcast", rounds=16, traffic=True)
    st3, ts3, _tel = psim.run_traffic(
        psim.init_state(z), psim.traffic_state(pspec), pspec, 12,
        donate=True, tel=PTM.init_state(tsp, "cpu"), tel_spec=tsp)
    for st, ts in ((st2, ts2), (st3, ts3)):
        assert torch.equal(st.received, st1.received)
        assert int(st.msgs) == int(st1.msgs)
        for a, b in zip(ts, ts1):
            assert torch.equal(a, b)


# -- backpressure accounting ---------------------------------------------


def grid_sim():
    return PB(to_padded_neighbors(jgrid(8)), n_values=64, srv_ledger=False,
              device="cpu")


def small_spec(**kw):
    base = dict(n_nodes=8, n_clients=8, ops_per_client=6, until=12,
                rate=0.4, seed=1)
    base.update(kw)
    return PT.TrafficSpec(**base)


def test_backpressure_deferral_is_loud_and_conserved():
    spec = small_spec(intake=0, until=6)
    sim = grid_sim()
    st, ts = sim.init_state(np.zeros((8, 2), np.uint32)), \
        sim.traffic_state(spec)
    expect = sum(int(PT.host_arrivals(spec, t).sum()) for t in range(6))
    st, ts = sim.run_traffic(st, ts, spec, 6)
    summ = PT.latency_summary(ts)
    assert summ["arrived"] == expect > 0
    assert summ["deferred"] == expect and summ["issued"] == 0
    assert summ["conserved"]


def test_conservation_holds_every_round():
    spec = small_spec(ops_per_client=2)
    sim = grid_sim()
    st, ts = sim.init_state(np.zeros((8, 2), np.uint32)), \
        sim.traffic_state(spec)
    host_arrived = 0
    for t in range(14):
        st, ts = sim.run_traffic(st, ts, spec, 1)
        host_arrived += int(PT.host_arrivals(spec, t).sum())
        summ = PT.latency_summary(ts)
        assert summ["conserved"], (t, summ)
        assert summ["arrived"] == host_arrived
        assert summ["issued"] == summ["completed"] + summ["in_flight"]
    assert summ["deferred"] > 0
    assert summ["in_flight"] == 0


def test_counter_amnesia_lost_op_never_completes():
    # node 2's round-0 op cannot flush (KV-blocked), its delta dies in the
    # round-1 amnesia wipe, and a later flush at the restarted node must
    # not claim it: it stays in flight as a lost acked write
    spec = small_spec(rate=1.0, kind="constant", until=6, ops_per_client=8)
    nspec = PF.NemesisSpec(n_nodes=8, seed=1, crash=((1, 3, (2,)),))
    blocked = np.zeros((1, 8), bool)
    blocked[0, 2] = True
    sim = PC(8, mode="allreduce", poll_every=2, device="cpu",
             kv_sched=PKR.from_numpy([0], [1], blocked),
             fault_plan=nspec.compile(device="cpu"))
    st, ts = sim.init_state(), sim.traffic_state(spec)
    st, ts = sim.run_traffic(st, ts, spec, 6, donate=True)
    for _ in range(8):
        st, ts = sim.run_traffic(st, ts, spec, 4, donate=True)
    summ = PT.latency_summary(ts)
    assert summ["arrived"] == 48
    assert summ["deferred"] == 2
    assert summ["in_flight"] == 1, summ
    assert summ["conserved"]
    assert int(st.kv) == summ["completed"]
    assert int((ts.op_aux == -2).sum()) == 1


def test_kafka_capacity_overflow_defers():
    spec = small_spec(until=8, rate=0.5)
    sim = PK(8, 2, capacity=1, max_sends=2, device="cpu")
    st, ts = sim.init_state(), sim.traffic_state(spec)
    st, ts = sim.run_traffic(st, ts, spec, 10)
    summ = PT.latency_summary(ts)
    assert summ["conserved"], summ
    assert summ["deferred"] > 0
    assert summ["issued"] <= 2
    assert summ["in_flight"] == 0


def test_traffic_rejects_unsupported_modes():
    spec = small_spec()
    with pytest.raises(ValueError, match="srv_ledger"):
        PB(to_padded_neighbors(jgrid(8)), n_values=64,
           device="cpu").run_traffic(None, None, spec, 1)
    with pytest.raises(ValueError, match="value universe"):
        PB(to_padded_neighbors(jgrid(8)), n_values=8, srv_ledger=False,
           device="cpu").run_traffic(None, None, spec, 1)
    with pytest.raises(ValueError, match="matmul"):
        PK(8, 2, capacity=8, repl_fast=False, device="cpu").run_traffic(
            None, None, spec, 1)
    for sim in (PB(to_padded_neighbors(jgrid(16)), n_values=64,
                   srv_ledger=False, device="cpu"), PC(16, device="cpu"),
                PK(16, 2, capacity=8, device="cpu")):
        with pytest.raises(ValueError, match="nodes"):
            sim.run_traffic(None, None, spec, 1)


def test_tel_key_validation():
    sim = PC(8, mode="cas", poll_every=2, device="cpu")
    spec = small_spec(ops_per_client=2, until=4, rate=0.5)
    bad = PTM.TelemetrySpec("counter", rounds=4)
    with pytest.raises(ValueError, match="traffic=True"):
        sim.run_traffic(sim.init_state(), sim.traffic_state(spec), spec, 4,
                        tel=PTM.init_state(bad, "cpu"), tel_spec=bad)
    with pytest.raises(ValueError, match="together"):
        sim.run_traffic(sim.init_state(), sim.traffic_state(spec), spec, 4,
                        tel=None, tel_spec=PTM.TelemetrySpec(
                            "counter", rounds=4, traffic=True))


def test_down_node_arrivals_defer_and_nothing_is_lost():
    # allreduce under a loss-free crash plan: arrivals at down nodes are
    # deferred, and no acked delta is wiped unflushed
    spec = small_spec(until=10)
    nspec = PF.NemesisSpec(n_nodes=8, seed=9, crash=((2, 8, (0, 3)),))
    sim = PC(8, mode="allreduce", poll_every=2, device="cpu",
             fault_plan=nspec.compile(device="cpu"))
    st, ts = sim.run_traffic(sim.init_state(), sim.traffic_state(spec),
                             spec, 10, donate=True)
    assert PT.latency_summary(ts)["deferred"] > 0
    for _ in range(10):
        st, ts = sim.run_traffic(st, ts, spec, 4, donate=True)
    summ = PT.latency_summary(ts)
    assert summ["conserved"] and summ["in_flight"] == 0, summ


def test_broadcast_wm_traffic_matches_gather():
    # the same spec through the gather path and the words-major tree on
    # the same graph: the same tracker, ledger and received sets (the
    # card's 2^20-node serving phase is held to the gather path on this)
    jspec, pspec = specs(until=10)
    sims = [broadcast_pair(case)[1] for case in ("gather", "wm")]
    z = np.zeros((N, 8), np.uint32)
    ends = []
    for sim in sims:
        st, ts = sim.run_traffic(sim.init_state(z), sim.traffic_state(pspec),
                                 pspec, 10, donate=True)
        st, ts = sim.run_traffic(st, ts, pspec, 20, donate=True)
        summ = PT.latency_summary(ts)
        assert summ["conserved"] and summ["in_flight"] == 0, summ
        ends.append((sim.received_node_major(st), int(st.msgs), ts))
    (ra, ma, ta), (rb, mb, tb) = ends
    assert (ra == rb).all() and ma == mb
    assert all(torch.equal(a, b) for a, b in zip(ta, tb))


def test_latency_checker_bites_on_delayed_op():
    # a tracker with one straggler: 9 ops done in 2 rounds, one in 40
    from gossip_glomers_tpu_torch.harness.checkers import check_op_latency

    done = torch.full((10, 1), 2, dtype=torch.int32)
    done[7, 0] = 40
    one = torch.ones((), dtype=torch.int64)
    ts = PT.TrafficState(
        issued_k=torch.ones(10, dtype=torch.int32),
        issue_round=torch.zeros((10, 1), dtype=torch.int32),
        done_round=done, op_aux=torch.full((10, 1), -1, dtype=torch.int32),
        arrived=10 * one, deferred=0 * one, completed=10 * one,
        deferred_resizing=0 * one)
    summ = PT.latency_summary(ts)
    ok, details = check_op_latency(summ, p99_max_rounds=8)
    assert not ok and any("p99" in p for p in details["problems"])
    assert check_op_latency(summ, p99_max_rounds=64)[0]
