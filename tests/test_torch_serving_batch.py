"""Serving batches on PyTorch against the reference's batches and the
port's own ``run_serving`` per cell, on the CPU, tolerance 0: a small
(load x fault x topology) broadcast grid and counter and Kafka grids
(rows, telemetry, signatures), and ``run_txn_frontier``."""

import numpy as np
import pytest

from gossip_glomers_tpu.harness import frontier as JFR
from gossip_glomers_tpu.harness import txn as JHTX
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import scenario as JSC
from gossip_glomers_tpu_torch.harness import serving as PS
from gossip_glomers_tpu_torch.harness import txn as HTX
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import scenario as SC
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT

# the frontier cartography's row keys a batch row shares with run_serving
PARITY_KEYS = ("arrived", "issued", "deferred", "completed", "in_flight",
               "conserved", "lat_p50", "lat_p99", "lat_max", "msgs_total",
               "total_rounds", "converged_round", "recovery_rounds", "ok")

LEVELS = (None, {"loss_rate": 0.15},
          {"n_crash_windows": 1, "loss_rate": 0.1, "dup_rate": 0.05})
GRIDS = {
    "broadcast": (("grid", "tree"), {"sync_every": 4}, LEVELS),
    "counter": (("grid",), {"mode": "cas", "poll_every": 2}, LEVELS),
    "kafka": (("grid",), {"n_keys": 4, "capacity": 32, "max_sends": 2,
                          "resync_every": 2},
              LEVELS[:2] + ({"n_crash_windows": 1, "loss_rate": 0.1},)),
}


@pytest.mark.parametrize("workload", sorted(GRIDS))
def test_serving_batch_matches_reference_and_run_serving(workload):
    topos, kw, levels = GRIDS[workload]
    cells = JFR.frontier_grid(workload, n_nodes=8, rates=(0.2, 0.6),
                              fault_levels=levels, topologies=topos,
                              until=6, seed=3)
    jb = JSC.ServingBatch(workload=workload, cells=tuple(cells),
                          runner_kw=kw, max_recovery_rounds=12,
                          drain_every=4)
    jres = JSC.run_serving_batch(jb, n_windows=2, telemetry_spec=True,
                                 signatures=True)
    pb = SC.ServingBatch.from_meta(jb.to_meta())
    pres = SC.run_serving_batch(pb, n_windows=2, telemetry_spec=True,
                                signatures=True, device="cpu")
    assert pres["cells"] == jres["cells"]
    assert pres["ok"] == jres["ok"] and pres["failing"] == jres["failing"]
    assert pres["telemetry"] == jres["telemetry"]
    np.testing.assert_array_equal(pres["signatures"],
                                  np.asarray(jres["signatures"]))
    for name in ("issued_k", "done_round", "completed"):
        np.testing.assert_array_equal(
            getattr(pres["trackers"], name).numpy(),
            np.asarray(getattr(jres["trackers"], name)))
    for c, row in zip(pb.cells, pres["cells"]):
        seq = PS.run_serving(workload, c.traffic, nemesis=c.spec,
                             sim_kw=SC._serving_sim_kw(pb, c),
                             max_recovery_rounds=12, drain_every=4,
                             device="cpu")
        for k in PARITY_KEYS:
            assert seq.get(k) == row.get(k), (row["cell"], k)


def test_serving_batch_refusals_match_reference():
    tspec = dict(n_nodes=8, n_clients=8, ops_per_client=2, until=4)
    mem = dict(n_nodes=8, seed=1, join=((2, (6, 7)),))
    for mod, tmod, fmod, extra in ((JSC, JFR.traffic, JF, {}),
                                   (SC, PT, PF, {"device": "cpu"})):
        cell = mod.ServingCell(traffic=tmod.TrafficSpec(**tspec),
                               spec=fmod.NemesisSpec(**mem))
        b = mod.ServingBatch(workload="broadcast", cells=(cell,),
                             runner_kw={"n_values": 16, "sync_every": 4})
        with pytest.raises(ValueError,
                           match="serving cell 0 carries membership"):
            mod.run_serving_batch(b, **extra)
        k = mod.ServingBatch(workload="kafka", cells=(
            mod.ServingCell(traffic=tmod.TrafficSpec(**tspec)),))
        with pytest.raises(ValueError, match="capacity"):
            mod.run_serving_batch(k, **extra)
        with pytest.raises(ValueError, match="mixes traffic statics"):
            mod.ServingBatch(workload="counter", cells=(
                mod.ServingCell(traffic=tmod.TrafficSpec(**tspec)),
                mod.ServingCell(traffic=tmod.TrafficSpec(
                    **dict(tspec, n_clients=16)))))
        with pytest.raises(ValueError, match="cover the horizon"):
            mod.run_serving_batch(
                mod.ServingBatch(workload="counter", cells=(
                    mod.ServingCell(traffic=tmod.TrafficSpec(**tspec)),)),
                telemetry_spec=mod.telemetry.TelemetrySpec(
                    "counter", rounds=4, traffic=True), **extra)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        SC.run_serving_batch(SC.ServingBatch(workload="counter", cells=(
            SC.ServingCell(traffic=PT.TrafficSpec(**tspec)),)),
            mesh=object(), device="cpu")


def test_txn_frontier_matches_reference():
    specs = [JF.NemesisSpec(n_nodes=8, seed=3),
             JF.NemesisSpec(n_nodes=8, seed=5, crash=((2, 5, (1, 6)),),
                            loss_rate=0.2, loss_until=6)]
    kw = dict(n_keys=8, txns_per_node=3, until=8, max_recovery_rounds=32,
              slo={"p99_max_rounds": 6.0, "max_recovery_rounds": 20})
    want = JHTX.run_txn_frontier([0.3, 0.7], specs, **kw)
    got = HTX.run_txn_frontier(
        [0.3, 0.7], [PF.NemesisSpec.from_meta(s.to_meta()) for s in specs],
        device="cpu", **kw)
    assert got == want
    assert got["n_cells"] == 4
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        HTX.run_txn_frontier([0.5], [], mesh=object(), device="cpu")
