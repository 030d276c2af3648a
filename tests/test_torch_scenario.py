"""Scenario batches on PyTorch, their operands and verdict layer: the
port's batched plans, partition schedules, traffic plans and Kafka
staging against the reference's leaves (tolerance 0, errors naming the
offending spec), ScenarioBatch / ServingBatch metas across the packages,
the copied checkers, the batched kernels' plain forms against S
one-scenario calls, and the shape knobs' invariance."""

import dataclasses

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import checkers as jc
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import scenario as JSC
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu_torch.harness import checkers as pc
from gossip_glomers_tpu_torch.parallel.topology import (grid,
                                                        to_padded_neighbors)
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import scenario as SC
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT


def hetero_specs(mod, n, count=6, horizon=8):
    """Specs with 0, 1 and 2 crash windows (the padding axis), loss and
    dup (the reference's tests/test_scenario.py draw)."""
    return [mod.random_spec(n, seed=s, horizon=horizon,
                            n_crash_windows=s % 3,
                            loss_rate=0.1 * (s % 2),
                            dup_rate=0.05 * (s % 3 == 0))
            for s in range(1, count + 1)]


def to_port(spec):
    return PF.NemesisSpec.from_meta(spec.to_meta())


@pytest.mark.parametrize("n_windows", [None, 4])
def test_batch_plans_leaves_equal_reference(n_windows):
    js = hetero_specs(JF, 16) + [JF.NemesisSpec(
        n_nodes=16, seed=2, join=((3, (14, 15)),), leave=((5, (0,)),))]
    got = PF.batch_plans([to_port(s) for s in js], n_windows,
                         device="cpu").leaves()
    want = JF.batch_plans(js, n_windows)
    for name in JF.FaultPlan._fields:
        w = np.asarray(getattr(want, name))
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_padded_plan_evaluates_like_its_original():
    spec = PF.random_spec(16, seed=3, horizon=8, n_crash_windows=1,
                          loss_rate=0.1)
    plan = spec.compile(device="cpu")
    padded = PF.pad_plan(plan, 4)
    assert len(padded.starts) == 4
    bp = PF.batch_plans([spec], 4, device="cpu")
    flags = bp.window_flags(12, "cpu")
    ids = torch.arange(16)
    for t in range(12):
        for p in (plan, padded, bp.plan(0)):
            assert torch.equal(PF.node_up(p, t, ids),
                               PF.node_up(plan, t, ids))
            assert torch.equal(PF.amnesia(p, t, ids),
                               PF.amnesia(plan, t, ids))
        assert torch.equal(bp.up(flags, t)[0], PF.node_up(plan, t, ids))
        assert torch.equal(bp.amnesia(flags, t)[0],
                           PF.amnesia(plan, t, ids))


def test_pad_and_batch_plans_name_the_offender():
    kw = dict(n_nodes=8, seed=1, crash=((1, 3, (0,)), (4, 6, (1,))))
    plan = PF.NemesisSpec(**kw).compile(device="cpu")
    jplan = JF.NemesisSpec(**kw).compile()
    for mod, p, broken in (
            (PF, plan, dataclasses.replace(plan, ends=plan.ends[:1])),
            (JF, jplan, jplan._replace(ends=jplan.ends[:1]))):
        with pytest.raises(ValueError, match="spec 3 has 2 crash windows"):
            mod.pad_plan(p, 1, where="spec 3")
        with pytest.raises(ValueError,
                           match="spec 7: window axes disagree"):
            mod.pad_plan(broken, 4, where="spec 7")
    for mod in (PF, JF):
        spec = mod.NemesisSpec(**kw)
        with pytest.raises(ValueError,
                           match="n_windows=1 < the batch's widest"):
            mod.batch_plans([spec], n_windows=1)
        with pytest.raises(ValueError, match="mixes n_nodes"):
            mod.batch_plans([spec, mod.random_spec(4, seed=1, horizon=8)])
        with pytest.raises(ValueError, match="at least one"):
            mod.batch_plans([])


def test_batch_partitions_leaves_equal_reference():
    n = 12
    g = (np.arange(n) % 2).tolist()
    metas = [None, {"starts": [2], "ends": [5], "group": [g]},
             {"starts": [1, 6], "ends": [3, 9],
              "group": [g, (np.arange(n) % 3).tolist()]}]
    got = SC.batch_partitions(metas, n)
    want = JSC.batch_partitions(metas, n)
    np.testing.assert_array_equal(got.starts, np.asarray(want.starts))
    np.testing.assert_array_equal(got.ends, np.asarray(want.ends))
    np.testing.assert_array_equal(got.group.numpy(), np.asarray(want.group))
    none = SC.batch_partitions([None, None], n)
    assert none.starts.shape == (2, 0) and none.group.shape == (2, 0, n)


def test_batch_tplans_leaves_and_errors_equal_reference():
    kw = dict(n_nodes=8, n_clients=8, ops_per_client=2, until=10)
    specs = [dict(kw, rate=0.3, seed=1),
             dict(kw, rate=0.2, seed=2, burst=((2, 4, 2.0),)),
             dict(kw, rate=0.1, seed=3, kind="constant",
                  burst=((1, 2, 3.0), (5, 7, 2.0)))]
    for n_burst in (None, 4):
        got = PT.batch_tplans([PT.TrafficSpec(**s) for s in specs], n_burst)
        want = JT.batch_tplans([JT.TrafficSpec(**s) for s in specs],
                               n_burst)
        for name, g, w in zip(JT.TrafficPlan._fields, got, want):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    for mod in (PT, JT):
        ts = [mod.TrafficSpec(**s) for s in specs]
        with pytest.raises(ValueError, match="n_burst=1 < the batch"):
            mod.batch_tplans(ts, 1)
        with pytest.raises(ValueError, match="mixes static shapes"):
            mod.batch_tplans([ts[0], mod.TrafficSpec(
                n_nodes=8, n_clients=16, ops_per_client=2, until=10)])
        with pytest.raises(ValueError, match="cannot pad to 0"):
            mod.pad_tplan(ts[1].compile(), 0)


def test_stage_kafka_batch_equals_reference():
    specs = [JF.random_spec(8, seed=10 + s, horizon=6, n_crash_windows=1,
                            loss_rate=0.1) for s in range(3)]
    jb = JSC.ScenarioBatch(
        workload="kafka",
        scenarios=tuple(JSC.Scenario(spec=sp, workload_seed=sp.seed)
                        for sp in specs), runner_kw={"rounds": 4})
    pb = SC.ScenarioBatch.from_meta(jb.to_meta())
    for quiesce in (0, 3):
        got = SC.stage_kafka_batch(pb, 12, n_keys=4, max_sends=2,
                                   send_prob=0.7, quiesce=quiesce)
        want = JSC.stage_kafka_batch(jb, 12, n_keys=4, max_sends=2,
                                     send_prob=0.7, quiesce=quiesce)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_metas_load_across_packages_and_pad_batch():
    n = 8
    nbrs = to_padded_neighbors(grid(n))
    scs = [JSC.Scenario(spec=sp, workload_seed=3,
                        parts={"starts": [1], "ends": [3],
                               "group": [(np.arange(n) % 2).tolist()]},
                        delays=tuple(tuple(int(v) for v in r)
                                     for r in np.full(nbrs.shape, 2)))
           for sp in hetero_specs(JF, n, count=3)]
    jb = JSC.ScenarioBatch(workload="broadcast", scenarios=tuple(scs),
                           runner_kw={"n_values": 16},
                           max_recovery_rounds=7)
    pb = SC.ScenarioBatch.from_meta(jb.to_meta())
    assert pb.to_meta() == jb.to_meta()
    assert JSC.ScenarioBatch.from_meta(pb.to_meta()).to_meta() == jb.to_meta()
    for mult in (1, 4, 8):
        (jp, jn), (pp, pn) = JSC.pad_batch(jb, mult), SC.pad_batch(pb, mult)
        assert jn == pn and pp.to_meta() == jp.to_meta()
    cells = [JSC.ServingCell(
        traffic=JT.TrafficSpec(n_nodes=n, n_clients=n, ops_per_client=2,
                               until=6, rate=0.2 * (i + 1), seed=i),
        spec=None if i == 0 else JF.random_spec(n, seed=i, horizon=6),
        topology=("grid", "tree")[i % 2], coords=(i, 0, i % 2))
        for i in range(3)]
    js = JSC.ServingBatch(workload="counter", cells=tuple(cells),
                          runner_kw={"mode": "cas"}, drain_every=4)
    ps = SC.ServingBatch.from_meta(js.to_meta())
    assert ps.to_meta() == js.to_meta()
    assert JSC.ServingBatch.from_meta(ps.to_meta()).to_meta() == js.to_meta()
    (jp, jn), (pp, pn) = (JSC.pad_serving_batch(js, 4),
                          SC.pad_serving_batch(ps, 4))
    assert jn == pn == 3 and pp.to_meta() == jp.to_meta()
    assert ps.cells[1].clear_round == js.cells[1].clear_round
    for mod in (SC, JSC):
        with pytest.raises(ValueError, match="unknown scenario workload"):
            mod.ScenarioBatch(workload="x", scenarios=(scs[0],))
        with pytest.raises(ValueError, match="needs >= 1"):
            mod.ServingBatch(workload="counter", cells=())


CRB_CASES = [
    dict(clear_rounds=np.array([4, 4, 6]),
         converged_rounds=np.array([6, -1, 20]), max_recovery_rounds=8,
         lost_writes=[[], [], [7]],
         msgs_at_clear=np.array([100, 100, 90]),
         msgs_at_converged=np.array([120, 100, 140])),
    dict(clear_rounds=np.array([0, 3]), converged_rounds=np.array([0, 5]),
         max_recovery_rounds=4, lost_writes=[[], []]),
    dict(clear_rounds=np.array([2]), converged_rounds=np.array([30]),
         max_recovery_rounds=4, lost_writes=[[{"lost_sum": 3}]],
         msgs_at_clear=np.array([0]), msgs_at_converged=np.array([5])),
]


@pytest.mark.parametrize("case", range(len(CRB_CASES)))
def test_check_recovery_batch_equals_reference(case):
    kw = CRB_CASES[case]
    assert pc.check_recovery_batch(**kw) == jc.check_recovery_batch(**kw)
    assert pc.check_recovery_batch.__module__ == pc.__name__


SLO_ROWS = [
    ({"cell": 3, "coords": [1, 2, 0], "completed": 10, "conserved": True,
      "lat_p50": 2.0, "lat_p99": 9.0, "lat_max": 11,
      "sustained_per_round": 0.5, "converged_round": 14,
      "recovery_rounds": 6},
     dict(p99_max_rounds=8, max_rounds=10, min_sustained=0.6,
          max_recovery_rounds=4)),
    ({"cell": 0, "completed": 0, "conserved": False,
      "converged_round": None, "in_flight": 4},
     dict(p99_max_rounds=8)),
    ({"cell": 1, "completed": 5, "lat_p50": 1.0, "lat_p99": 2.0,
      "lat_max": 2, "converged_round": 3, "recovery_rounds": 0},
     dict(p99_max_rounds=8, coords=(9, 9))),
]


@pytest.mark.parametrize("case", range(len(SLO_ROWS)))
def test_check_slo_equals_reference(case):
    row, kw = SLO_ROWS[case]
    assert pc.check_slo(row, **kw) == jc.check_slo(row, **kw)
    assert pc.check_slo.__module__ == pc.__name__


def coin_case(s, n, d, seed):
    """A folded (S N, D) table with -1 pads and its per-scenario pieces:
    the one-scenario (N, D) tables, liveness, live masks and a coin table
    mixing every loss / dup stream state."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(-1, n, (s, n, d)).astype(np.int32)
    off = (np.arange(s) * n)[:, None, None]
    fold = np.where(nb >= 0, nb + off, -1).reshape(s * n, d)
    up = rng.random((s, n)) < 0.8
    live = (rng.random((s, n, d)) < 0.7) & (nb >= 0)
    tab = np.stack([rng.integers(0, 2**32, s),
                    rng.integers(0, 2**32, s) // 3,
                    rng.integers(0, 2**32, s) // 4,
                    np.arange(s) % 2, (np.arange(s) // 2) % 2], axis=1)
    return (torch.from_numpy(fold.astype(np.int32)),
            torch.from_numpy(nb), torch.from_numpy(up),
            torch.from_numpy(live), torch.from_numpy(tab.astype(np.int64)))


@pytest.mark.parametrize("s,n,d", [(1, 24, 4), (3, 24, 3), (5, 1, 2),
                                   (4, 17, 8)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("out_ok", [False, True])
def test_batched_fault_coins_plain_equals_one_scenario_calls(s, n, d, masked,
                                                           out_ok):
    fold, nb, up, live, tab = coin_case(s, n, d, seed=s * 100 + n)
    t = 5
    got = kernels.fault_coins_plain(
        fold, up.reshape(-1), t=t, out_ok=out_ok, table=tab, block=n,
        live=live.reshape(s * n, d) if masked else None)
    rows = got.view(s, n, d)
    for k in range(s):
        want = kernels.fault_coins_plain(
            nb[k], up[k], t=t, seed=int(tab[k, 0]),
            loss_num=int(tab[k, 1]), dup_num=int(tab[k, 2]),
            loss=bool(tab[k, 3]), dup=bool(tab[k, 4]), out_ok=out_ok,
            live=live[k] if masked else None)
        assert torch.equal(rows[k], want), k
    # a slab of whole scenarios (row0) is the same rows of the whole call
    if s > 1:
        lo = n
        part = kernels.fault_coins(
            fold[lo:], up.reshape(-1), t=t, out_ok=out_ok, table=tab,
            block=n, row0=lo,
            live=live.reshape(s * n, d)[lo:] if masked else None)
        assert torch.equal(part, got[lo:])


@pytest.mark.parametrize("s,n,w,d", [(1, 24, 1, 4), (3, 24, 2, 3),
                                     (6, 1, 1, 2), (2, 40, 5, 8)])
@pytest.mark.parametrize("dup", [False, True])
def test_batched_faulted_gather_round_plain_equals_one_scenario_calls(
        s, n, w, d, dup):
    fold, nb, up, live, tab = coin_case(s, n, d, seed=7 * s + w)
    tab[:, 4] = 1
    flags = kernels.fault_coins_plain(fold, up.reshape(-1), t=3, table=tab,
                                      block=n)
    rng = np.random.default_rng(w)
    payload = torch.from_numpy(rng.integers(
        -2**31, 2**31, (s * n, w)).astype(np.int32))
    recv = payload | torch.from_numpy(rng.integers(
        -2**31, 2**31, (s * n, w)).astype(np.int32))
    rec = torch.from_numpy(rng.integers(
        -2**31, 2**31, (s * n, w)).astype(np.int32))
    new, rec_next, dup_pc = kernels.faulted_gather_round(
        payload, recv if dup else None, rec, fold, flags, block=n)
    assert dup_pc.shape == (s,)
    for k in range(s):
        sl = slice(k * n, (k + 1) * n)
        want = kernels.faulted_gather_round_plain(
            payload[sl], recv[sl] if dup else None, rec[sl], nb[k],
            flags[sl])
        assert torch.equal(new[sl], want[0])
        assert torch.equal(rec_next[sl], want[1])
        assert int(dup_pc[k]) == int(want[2])


def test_batched_kernel_arguments_are_checked():
    fold, _nb, up, _live, tab = coin_case(2, 4, 2, seed=1)
    with pytest.raises(ValueError, match="block"):
        kernels.fault_coins(fold, up.reshape(-1), t=0, table=tab, block=3)
    with pytest.raises(ValueError, match="table"):
        kernels.fault_coins(fold, up.reshape(-1), t=0, table=tab[:1],
                            block=4)
    pay = torch.zeros((8, 1), dtype=torch.int32)
    flags = torch.zeros((8, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not divide"):
        kernels.faulted_gather_round(pay, None, pay, fold, flags, block=3)


def test_stack_pytrees_and_state_bytes():
    from gossip_glomers_tpu_torch.tpu_sim import counter as CT

    sim = CT.CounterSim(8, device="cpu")
    st = SC.stack_pytrees([sim.init_state(), sim.init_state()])
    assert st.pending.shape == (2, 8) and st.t.tolist() == [0, 0]
    from gossip_glomers_tpu_torch.tpu_sim import kafka as KF
    from gossip_glomers_tpu_torch.tpu_sim.engine import operand_bytes

    # the formula is the port's staged state's bytes: the counter's two
    # rows, Kafka's presence, log, cells and committed cache, and the
    # folded broadcast batch's two bitsets
    states = [sim.init_state()] * 3
    assert sum(operand_bytes((x.pending, x.cached)) for x in states) == \
        SC.batch_state_bytes("counter", 3, 8) == \
        JSC.batch_state_bytes("counter", 3, 8)
    ks = KF.KafkaSim(8, 4, 32, device="cpu").init_state()
    assert operand_bytes((ks.present, ks.log_vals, ks.kv_val,
                          ks.local_committed)) == \
        SC.batch_state_bytes("kafka", 1, 8, n_keys=4, capacity=32)
    batch = SC.ScenarioBatch(workload="broadcast", runner_kw={
        "n_values": 40}, scenarios=(PF.NemesisSpec(n_nodes=8),) * 3)
    st = SC.stage_broadcast_batch(batch, device="cpu")["state"]
    assert operand_bytes((st.received, st.frontier)) == \
        SC.batch_state_bytes("broadcast", 3, 8, nv=40)
    assert SC.serving_state_bytes("kafka", 2, 8, 8, 2, n_keys=4,
                                  capacity=32) == \
        JSC.serving_state_bytes("kafka", 2, 8, 8, 2, n_keys=4, capacity=32)


def test_shape_knobs_leave_the_rows_unchanged():
    """``n_windows`` and ``min_rounds`` pad the plans and floor the trip:
    the rows, signatures and telemetry stay the plain batch's, in the
    port and in the reference."""
    from gossip_glomers_tpu.tpu_sim import telemetry as JTM
    from gossip_glomers_tpu_torch.tpu_sim import telemetry as PTM

    n = 12
    js = JSC.ScenarioBatch(
        workload="broadcast",
        scenarios=tuple(JSC.Scenario(spec=sp)
                        for sp in hetero_specs(JF, n, count=4)),
        runner_kw={"n_values": 24, "topology": "grid"},
        max_recovery_rounds=16)
    ps = SC.ScenarioBatch.from_meta(js.to_meta())
    rows, want = [], None
    for knobs in ({}, {"n_windows": 4}, {"min_rounds": 40},
                  {"n_windows": 3, "min_rounds": 30}):
        tel_r = 40
        got = SC.run_scenario_batch(
            ps, telemetry_spec=PTM.TelemetrySpec("broadcast", rounds=tel_r),
            signatures=True, device="cpu", **knobs)
        rows.append((got["scenarios"], got["signatures"].tolist(),
                     got["telemetry"]))
        if want is None:
            want = JSC.run_scenario_batch(
                js, telemetry_spec=JTM.TelemetrySpec("broadcast",
                                                     rounds=tel_r),
                signatures=True, **knobs)
            assert got["scenarios"] == want["scenarios"]
            assert got["signatures"].tolist() == \
                np.asarray(want["signatures"]).tolist()
    assert all(r == rows[0] for r in rows[1:])


def test_stale_dcn_and_mesh_refusals(monkeypatch):
    batch = SC.ScenarioBatch(
        workload="counter",
        scenarios=(SC.Scenario(spec=PF.NemesisSpec(n_nodes=4)),))
    with pytest.raises(NotImplementedError, match="item 10"):
        SC.run_scenario_batch(batch, mesh=object(), device="cpu")
    monkeypatch.setenv("GG_DCN_STALE_K", "2")
    with pytest.raises(ValueError, match="bounded"):
        SC.run_scenario_batch(batch, device="cpu")
    with pytest.raises(ValueError, match="bounded"):
        JSC._refuse_stale_dcn("a scenario batch")
    monkeypatch.delenv("GG_DCN_STALE_K")
    with pytest.raises(ValueError, match="stale:3"):
        SC._refuse_stale_dcn("a serving batch", {"dcn_mode": "stale:3"})
    SC._refuse_stale_dcn("a serving batch", {"dcn_mode": "pipelined"})
    assert SC.run_scenario_batch(batch, device="cpu")["ok"]


@pytest.mark.parametrize("s,n,w", [(1, 5, 1), (4, 3, 2), (6, 1, 4)])
def test_fold_freeze_copies_the_active_scenarios_rows(s, n, w):
    rng = np.random.default_rng(s * n + w)
    dst = torch.from_numpy(rng.integers(-2**31, 2**31, (s * n, w))
                           .astype(np.int32))
    src = torch.from_numpy(rng.integers(-2**31, 2**31, (s * n, w))
                           .astype(np.int32))
    active = torch.from_numpy(rng.random(s) < 0.5)
    for two in (False, True):
        d0, d1 = dst.clone(), dst.clone()
        kernels.fold_freeze(d0, src, active, n, d1 if two else None,
                            src if two else None)
        for k in range(s):
            rows = slice(k * n, (k + 1) * n)
            want = src[rows] if active[k] else dst[rows]
            assert torch.equal(d0[rows], want)
            assert torch.equal(d1[rows], want if two else dst[rows])
    with pytest.raises(ValueError, match="active"):
        kernels.fold_freeze(dst.clone(), src, active[:-1], n)
    with pytest.raises(ValueError, match="aliases"):
        kernels.fold_freeze(dst, dst, active, n)
