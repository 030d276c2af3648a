"""Scenario batches on PyTorch against the reference's batches and the
port's own one-scenario runners, on the CPU, tolerance 0: the folded
broadcast batch (heterogeneous crash windows, partitions, per-edge
delays, dup, membership, telemetry, signatures), the looped counter,
Kafka and txn batches, and a planted failing scenario named by its
index."""

import numpy as np
import pytest

from gossip_glomers_tpu.harness import fuzz as JFZ
from gossip_glomers_tpu.parallel.topology import grid, to_padded_neighbors
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import scenario as JSC
from gossip_glomers_tpu.tpu_sim import telemetry as JTM
from gossip_glomers_tpu_torch.harness import nemesis as NM
from gossip_glomers_tpu_torch.harness import txn as HTX
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import scenario as SC
from gossip_glomers_tpu_torch.tpu_sim import telemetry as PTM
from gossip_glomers_tpu_torch.tpu_sim.broadcast import Partitions


def hetero_specs(n, count=6, horizon=8):
    return [JF.random_spec(n, seed=s, horizon=horizon,
                           n_crash_windows=s % 3, loss_rate=0.1 * (s % 2),
                           dup_rate=0.05 * (s % 3 == 0))
            for s in range(1, count + 1)]


def both(jbatch, rounds=None, **kw):
    """(reference result, port result) of one batch; ``rounds``: a
    telemetry ring of that many rounds on both."""
    pbatch = SC.ScenarioBatch.from_meta(jbatch.to_meta())
    jkw, pkw = dict(kw), dict(kw)
    if rounds is not None:
        jkw["telemetry_spec"] = JTM.TelemetrySpec(jbatch.workload,
                                                  rounds=rounds)
        pkw["telemetry_spec"] = PTM.TelemetrySpec(jbatch.workload,
                                                  rounds=rounds)
    return (JSC.run_scenario_batch(jbatch, **jkw),
            SC.run_scenario_batch(pbatch, device="cpu", **pkw))


def assert_same(jres, pres):
    assert pres["ok"] == jres["ok"]
    assert pres["failing"] == jres["failing"]
    assert pres["scenarios"] == jres["scenarios"]
    if "telemetry" in jres:
        assert pres["telemetry"] == jres["telemetry"]
    if "signatures" in jres:
        np.testing.assert_array_equal(pres["signatures"],
                                      np.asarray(jres["signatures"]))


def seq_broadcast(sc, nv: int, mrr: int, telemetry=None) -> dict:
    """One port scenario through the port's run_broadcast_nemesis."""
    return NM.run_broadcast_nemesis(
        sc.spec, n_values=nv, topology="grid", sync_every=4,
        max_recovery_rounds=mrr,
        parts=None if sc.parts is None else Partitions.from_meta(sc.parts),
        delays=None if sc.delays is None else np.asarray(sc.delays),
        telemetry=telemetry, device="cpu")


def seq_series_equal(seq: dict, series: dict, i) -> None:
    for k, v in seq["telemetry"]["series"].items():
        if not k.startswith("_"):
            assert series[k] == v, (i, k)


@pytest.mark.parametrize("delayed", [True, False])
def test_broadcast_batch_matches_reference_and_sequential(delayed):
    """The reference's tests/test_scenario.py case: heterogeneous window
    counts, partition windows on odd scenarios, per-edge delays 1-2 (or
    one hop), dup on every third, telemetry; rows, final received sets,
    telemetry series and signatures against the reference's batch, and
    every scenario against the port's run_broadcast_nemesis."""
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
        cases.append(JSC.Scenario(spec=sp, parts=parts,
                                  delays=delays if delayed else None))
    jb = JSC.ScenarioBatch(
        workload="broadcast", scenarios=tuple(cases),
        runner_kw={"n_values": nv, "topology": "grid", "sync_every": 4},
        max_recovery_rounds=32)
    jres, pres = both(jb, rounds=8 + 32, signatures=True)
    assert_same(jres, pres)
    np.testing.assert_array_equal(
        pres["final"].received.numpy().view(np.uint32),
        np.asarray(jres["final"].received))
    np.testing.assert_array_equal(
        pres["final"].frontier.numpy().view(np.uint32),
        np.asarray(jres["final"].frontier))
    tel = PTM.TelemetrySpec("broadcast", rounds=40)
    for i, sc in enumerate(SC.ScenarioBatch.from_meta(jb.to_meta())
                           .scenarios):
        seq = seq_broadcast(sc, nv, 32, telemetry=tel)
        row = pres["scenarios"][i]
        for k in ("converged_round", "recovery_rounds", "msgs_total", "ok",
                  "lost_writes"):
            assert row[k] == seq[k], (i, k)
        seq_series_equal(seq, pres["telemetry"][i], i)


def test_counter_batch_matches_reference_and_sequential():
    n = 16
    specs = []
    for s in range(1, 5):
        meta = JF.random_spec(n, seed=s, horizon=8,
                              n_crash_windows=1 + (s % 2),
                              loss_rate=0.1).to_meta()
        # the sweep's counter move: crash after the cas drain
        meta["crash"] = [[a + n + 2, b + n + 2, ns]
                         for a, b, ns in meta["crash"]]
        meta["loss_until"] += n + 2
        specs.append(JF.NemesisSpec.from_meta(meta))
    jb = JSC.ScenarioBatch(
        workload="counter",
        scenarios=tuple(JSC.Scenario(spec=sp) for sp in specs),
        runner_kw={"mode": "cas", "poll_every": 2}, max_recovery_rounds=48)
    r = max(sp.clear_round for sp in specs) + 48
    jres, pres = both(jb, rounds=r, signatures=True)
    assert_same(jres, pres)
    for name in ("pending", "cached", "kv"):
        np.testing.assert_array_equal(
            getattr(pres["final"], name).numpy(),
            np.asarray(getattr(jres["final"], name)))
    tel = PTM.TelemetrySpec("counter", rounds=r)
    for i, sp in enumerate(specs):
        seq = NM.run_counter_nemesis(
            PF.NemesisSpec.from_meta(sp.to_meta()), mode="cas",
            poll_every=2, max_recovery_rounds=48, telemetry=tel,
            device="cpu")
        row = pres["scenarios"][i]
        for k in ("converged_round", "msgs_total", "ok", "kv"):
            assert row[k] == seq[k], (i, k)
        seq_series_equal(seq, pres["telemetry"][i], i)


def test_kafka_batch_matches_reference_and_sequential():
    n = 16
    specs = [JF.random_spec(n, seed=10 + s, horizon=8,
                            n_crash_windows=1 + (s % 2), loss_rate=0.1)
             for s in range(4)]
    kw = {"n_keys": 4, "capacity": 64, "max_sends": 2, "resync_every": 4,
          "send_prob": 0.7}
    jb = JSC.ScenarioBatch(
        workload="kafka",
        scenarios=tuple(JSC.Scenario(spec=sp, workload_seed=sp.seed)
                        for sp in specs),
        runner_kw=kw, max_recovery_rounds=24)
    r = max(sp.clear_round for sp in specs) + 24
    jres, pres = both(jb, rounds=r, signatures=True)
    assert_same(jres, pres)
    np.testing.assert_array_equal(
        pres["final"].present.numpy(),
        np.asarray(jres["final"].present).view(np.int32))
    np.testing.assert_array_equal(pres["final"].log_vals.numpy(),
                                  np.asarray(jres["final"].log_vals))
    tel = PTM.TelemetrySpec("kafka", rounds=r)
    for i, sp in enumerate(specs):
        seq = NM.run_kafka_nemesis(
            PF.NemesisSpec.from_meta(sp.to_meta()), n_keys=4, capacity=64,
            max_sends=2, resync_every=4, workload_seed=sp.seed,
            commits=False, max_recovery_rounds=24, telemetry=tel,
            device="cpu")
        row = pres["scenarios"][i]
        for k in ("converged_round", "msgs_total", "ok", "n_allocated"):
            assert row[k] == seq[k], (i, k)
        seq_series_equal(seq, pres["telemetry"][i], i)


def test_txn_batch_matches_reference_and_sequential():
    """The reference's tests/test_txn.py batch: four crash / loss
    campaigns, rows against its batch and the port's run_txn_nemesis."""
    n = 8
    specs = [
        JF.NemesisSpec(n_nodes=n, seed=11),
        JF.NemesisSpec(n_nodes=n, seed=5, crash=((2, 5, (1,)),)),
        JF.NemesisSpec(n_nodes=n, seed=9, loss_rate=0.3, loss_until=8),
        JF.NemesisSpec(n_nodes=n, seed=4, crash=((3, 6, (2, 5)),),
                       loss_rate=0.2, loss_until=6),
    ]
    jb = JSC.ScenarioBatch(
        workload="txn",
        scenarios=tuple(JSC.Scenario(spec=sp, workload_seed=sp.seed)
                        for sp in specs),
        runner_kw=dict(n_keys=8, txns_per_node=4, ops_per_txn=2, rate=0.5,
                       until=12),
        max_recovery_rounds=32)
    jres, pres = both(jb)
    assert_same(jres, pres)
    assert pres["ok"] and len(pres["scenarios"]) == 4
    for name in ("issue_round", "commit_round", "op_ver", "op_val"):
        np.testing.assert_array_equal(
            getattr(pres["final"], name).numpy(),
            np.asarray(getattr(jres["final"], name)))
    for sp, row in zip(specs, pres["scenarios"]):
        seq = HTX.run_txn_nemesis(PF.NemesisSpec.from_meta(sp.to_meta()),
                                  n_keys=8, until=12, workload_seed=sp.seed,
                                  max_recovery_rounds=32, device="cpu")
        for k in ("ok", "converged_round", "msgs_total", "n_committed",
                  "serializable"):
            assert row[k] == seq[k], k


def test_txn_batch_refusals_match_reference():
    dup = JF.NemesisSpec(n_nodes=8, seed=0, dup_rate=0.2, dup_until=4)
    mem = JF.NemesisSpec(n_nodes=8, seed=1, join=((2, (6, 7)),))
    for spec, match in ((dup, "dup"), (mem, "txn scenario 0 carries "
                                            "membership")):
        jb = JSC.ScenarioBatch(workload="txn",
                               scenarios=(JSC.Scenario(spec=spec),),
                               runner_kw=dict(until=8))
        with pytest.raises(ValueError, match=match):
            JSC.run_scenario_batch(jb)
        with pytest.raises(ValueError, match=match):
            SC.run_scenario_batch(SC.ScenarioBatch.from_meta(jb.to_meta()),
                                  device="cpu")
    pb = SC.ScenarioBatch(workload="txn", scenarios=(
        SC.Scenario(spec=PF.NemesisSpec(n_nodes=8)),))
    with pytest.raises(ValueError, match="telemetry"):
        SC.run_scenario_batch(pb, device="cpu",
                              telemetry_spec=PTM.TelemetrySpec(
                                  "broadcast", rounds=8))
    with pytest.raises(NotImplementedError, match="item 10"):
        SC.run_scenario_batch(pb, device="cpu", mesh=object())


def test_planted_failure_is_named_by_its_index():
    """A single planted bad scenario among 64 fails loudly, named by its
    index, with lost-writes evidence — the whole batch's rows equal the
    reference's."""
    n = 24
    cells = JFZ.sample_scenarios("broadcast", 64, n_nodes=n, seed=5,
                                 horizon=8)
    planted = 37
    cells[planted] = JFZ.planted_failure("broadcast", n, 8)
    jb = JSC.ScenarioBatch(
        workload="broadcast", scenarios=tuple(cells),
        runner_kw={"n_values": 2 * n, "topology": "grid", "sync_every": 4},
        max_recovery_rounds=48)
    jres, pres = both(jb)
    assert_same(jres, pres)
    assert planted in pres["failing"] and not pres["ok"]
    row = pres["scenarios"][planted]
    assert not row["ok"] and row["n_lost_writes"] > 0
    sc = SC.ScenarioBatch.from_meta(jb.to_meta()).scenarios[planted]
    seq = seq_broadcast(sc, 2 * n, 48)
    assert seq["lost_writes"] == row["lost_writes"] and not seq["ok"]


def test_membership_churn_batch_matches_reference_and_sequential():
    """The reference's membership batch, cut to 8 scenarios and no mesh:
    joins and leaves composed with crash windows and loss (member-scoped
    convergence and evidence), the resize-shaped grow and shrink blocks
    crossing live crash windows, signatures (their fifth field the churn
    bucket)."""
    n, horizon = 12, 6
    cells = JFZ.sample_scenarios("broadcast", 6, n_nodes=n, seed=6,
                                 horizon=horizon, membership_axis=True)
    cells += [
        JSC.Scenario(spec=JF.NemesisSpec(
            n_nodes=n, seed=7001, crash=((2, 6, (1, 2)),),
            join=((4, (9, 10, 11)),))),
        JSC.Scenario(spec=JF.NemesisSpec(
            n_nodes=n, seed=7003, crash=((3, 7, (2,)),),
            leave=((5, (9, 10, 11)),)))]
    assert any(sc.spec.has_membership for sc in cells[:6])
    kw = {"n_values": 24, "topology": "grid", "sync_every": 4}
    jb = JSC.ScenarioBatch(workload="broadcast", scenarios=tuple(cells),
                           runner_kw=kw, max_recovery_rounds=32)
    r = max(sc.spec.clear_round for sc in cells) + 32
    jres, pres = both(jb, rounds=r, signatures=True)
    assert_same(jres, pres)
    assert pres["scenarios"][6]["ok"] and pres["scenarios"][7]["ok"]
    churn = [sum(len(ns) for _r, ns in sc.spec.join + sc.spec.leave)
             for sc in cells]
    assert [int(s) for s in pres["signatures"][:, 4]] == \
        [PTM.log2_bucket(c) for c in churn]
    for i, sc in enumerate(SC.ScenarioBatch.from_meta(jb.to_meta())
                           .scenarios):
        seq = seq_broadcast(sc, 24, 32)
        row = pres["scenarios"][i]
        for k in ("converged_round", "recovery_rounds", "msgs_total", "ok",
                  "lost_writes"):
            assert row[k] == seq[k], (i, k)


def test_membership_counter_and_kafka_batches_match_reference():
    n = 12
    cells = JFZ.sample_scenarios("counter", 4, n_nodes=n, seed=8,
                                 horizon=6, membership_axis=True)
    assert any(sc.spec.has_membership for sc in cells)
    for wl, kw in (("counter", {"mode": "cas", "poll_every": 2}),
                   ("kafka", {"n_keys": 4, "capacity": 32, "max_sends": 1,
                              "resync_every": 2, "send_prob": 0.5})):
        jb = JSC.ScenarioBatch(workload=wl, scenarios=tuple(cells),
                               runner_kw=kw, max_recovery_rounds=40)
        jres, pres = both(jb, pad_to=8)
        assert_same(jres, pres)
        assert pres["n_scenarios"] == 4
