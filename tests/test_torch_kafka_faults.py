"""Port parity for Kafka under Maelstrom's faults: the port's ``KafkaSim``
under a crash / loss (/ dup) ``FaultPlan`` against the JAX reference's on
the CPU, every field at every round: the faulted origin union
materialized, in ``union_block`` slabs and through the matmul oracle, the
pull and push resync (``resync_every`` 4 and 0), nemesis campaigns run to
convergence; the device KV backend against the host one and the
reference's, with ``kv_amnesia``; the constructor's refusals; and the
port's campaign staging (which chip_smoke.py uses) against the
harness's.

Mirrors tests/test_nemesis.py :173-238 and :312-410 and
tests/test_kvstore.py :274 and :298 off-mesh.  Specs and batches come
from seeded numpy; every field compares exactly (tolerance 0).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from gossip_glomers_tpu.harness import nemesis as H
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kafka as pk
from torch_kafka_twins import drive, port_plan, same, sims

ROOT = Path(__file__).resolve().parent.parent


def _nem_spec(n, dup=True):
    kw = dict(dup_rate=0.1, dup_until=10) if dup else {}
    return jf.NemesisSpec(n_nodes=n, seed=11, crash=((3, 7, (1, 4)),),
                          loss_rate=0.25, loss_until=10, **kw)


PATHS = {"materialized": {"union_block": "materialized"},
         "blocked-1": {"union_block": 1},
         "blocked-3": {"union_block": 3},
         "matmul": {"repl_fast": False}}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mode", ("pull", "push"))
def test_faulted_round_matches_reference(mode, path):
    # tests/test_nemesis.py :342: crash + loss + dup, every replication
    # path, commits and the resync, then quiescent rounds past the faults
    n, k, cap, s, r = 12, 4, 64, 2, 10
    spec = _nem_spec(n)
    sks, svs, crs = H.stage_kafka_ops(spec, r, n_keys=k, max_sends=s)
    jsim, psim = sims(n, k, cap, spec=spec, max_sends=s, resync_mode=mode,
                      **PATHS[path])
    assert psim._ub == jsim._ub
    assert psim._repl_mode(None) == jsim._repl_mode(None)
    drive(jsim, psim, sks, svs, crs, quiet=6)


def test_blocked_union_seed_replay_across_block_sizes():
    # tests/test_nemesis.py :383: slabs of 64, the whole axis and the
    # materialized path agree, and a replay is bit-exact
    spec = jf.NemesisSpec(n_nodes=128, seed=23, crash=((2, 5, (3, 77)),),
                          loss_rate=0.2, loss_until=8)
    n, k, cap, s, r = 128, 8, 64, 1, 8
    sks, svs, crs = H.stage_kafka_ops(spec, r, n_keys=k, max_sends=s,
                                      workload_seed=4)
    plan = port_plan(spec.compile())
    outs = {}
    for ub in (64, 128, "materialized", "replay"):
        sim = pk.KafkaSim(n, k, cap, max_sends=s, fault_plan=plan,
                          union_block=64 if ub == "replay" else ub,
                          device="cpu")
        outs[ub] = sim.run_fused(sim.init_state(), sks, svs, crs)
    jsim = sims(n, k, cap, spec=spec, max_sends=s,
                union_block="materialized")[0]
    ref = jsim.run_fused(jsim.init_state(), sks, svs, crs)
    for name, st in outs.items():
        same(ref, st, name)


def test_push_resync_waits_for_crashed_origin():
    # tests/test_nemesis.py :238: while node 0 is down its presence row is
    # wiped and its durable origin bits stay
    spec = jf.NemesisSpec(n_nodes=6, seed=3, crash=((1, 9, (0,)),))
    sks, svs, crs = H.stage_kafka_ops(spec, 6, n_keys=4, max_sends=2,
                                      workload_seed=2)
    jsim, sim = sims(6, 4, 64, spec=spec, max_sends=2, resync_mode="push")
    js, st = jsim.init_state(), sim.init_state()
    for t in range(4):
        js = jsim.step(js, sks[t], svs[t], crs[t])
        st = sim.step(st, sks[t], svs[t], crs[t])
        same(js, st, t)
    assert int(st.present[0].abs().sum()) == 0
    assert int(st.origin_bits[0].abs().sum()) > 0


def _campaign(sim, spec, rounds, sks, svs, crs, limit=48):
    """run_kafka_nemesis's campaign on a sim: the staged rounds fused,
    then quiescent rounds until every node's presence agrees.  Returns
    (state, converged round or None)."""
    st = sim.run_fused(sim.init_state(), sks, svs, crs)

    def converged(s):
        pres = np.asarray(s.present) if not hasattr(s.present, "numpy") \
            else s.present.numpy()
        return bool((pres == pres[:1]).all())

    conv = rounds if converged(st) else None
    while conv is None and int(st.t) < rounds + limit:
        st = sim.step(st)
        if converged(st):
            conv = int(st.t)
    return st, conv


@pytest.mark.parametrize("mode,every", (("pull", 4), ("push", 4),
                                        ("pull", 0)))
def test_nemesis_campaign_converges_like_reference(mode, every):
    # tests/test_nemesis.py :173 and :183: the campaign certifies (no
    # allocated slot lost, no cache above its cell) and the port's run
    # equals the reference's, converged round and ledger included
    spec = _nem_spec(8, dup=False)
    sks, svs, crs = H.stage_kafka_ops(spec, 12, n_keys=4, max_sends=2)
    jsim, psim = sims(8, 4, 64, spec=spec, max_sends=2, resync_mode=mode,
                      resync_every=every)
    js, jconv = _campaign(jsim, spec, 12, sks, svs, crs)
    ps, pconv = _campaign(psim, spec, 12, sks, svs, crs)
    same(js, ps)
    assert pconv == jconv and pconv is not None
    pres = psim.present_bool(ps)
    allocated = ps.log_vals.numpy() >= 0
    assert not (allocated & ~pres.any(axis=0)).any()
    kv = ps.kv_val.numpy()
    assert not (ps.local_committed.numpy()
                > np.where(kv > 0, kv, 0)[None, :]).any()


def _drive_device_kv(sim):
    """tests/test_kvstore.py ``_drive_kafka``: burst sends, commit dances
    (active, overshoot learn, local skip), a second wave and a contended
    CAS; the cells, each node's committed offsets and the ledger after
    every phase, and the polls at the end."""
    n = sim.n_nodes
    st = sim.init_state()
    trail = []

    def snap(s):
        trail.append((sim.lin_kv(s),
                      {i: sim.list_committed(s, i) for i in range(n)},
                      int(s.msgs)))

    sk = np.full((n, 1), -1, np.int32)
    sv = np.zeros((n, 1), np.int32)
    sk[0:4, 0] = 0
    sk[4:6, 0] = 1
    sv[0:6, 0] = np.arange(10, 16, dtype=np.int32)
    st = sim.step(st, sk, sv)
    snap(st)
    cr = np.full((n, 2), -1, np.int32)
    cr[0, 0], cr[6, 0], cr[4, 1] = 2, 1, 1
    st = sim.step(st, commit_req=cr)
    snap(st)
    sk2 = np.full((n, 1), -1, np.int32)
    sv2 = np.zeros((n, 1), np.int32)
    sk2[7, 0], sv2[7, 0] = 0, 99
    st = sim.step(st, sk2, sv2)
    cr2 = np.full((n, 2), -1, np.int32)
    cr2[2, 0] = cr2[3, 0] = 4
    st = sim.step(st, commit_req=cr2)
    snap(st)
    trail.append([sim.poll(st, i, 0, 0) for i in range(n)])
    return trail, st


def test_device_backend_matches_host_backend_and_reference():
    # tests/test_kvstore.py :274
    host = pk.KafkaSim(8, 2, 32, max_sends=1, device="cpu")
    jsim, dev = sims(8, 2, 32, max_sends=1, kv_backend="device")
    trail, st = _drive_device_kv(dev)
    assert trail == _drive_device_kv(host)[0]
    jtrail, js = _drive_device_kv(jsim)
    assert trail == jtrail
    same(js, st)
    # the store's rows hold the cells
    view = pk.kvstore.rows_view_at(st.rows, dev._slots)[0]
    assert (view == st.kv_val).all()


@pytest.mark.parametrize("mode", ("pull", "push"))
def test_device_backend_with_kv_amnesia_matches_reference(mode):
    # the device KV under the plan: a restarting owner loses its rows, and
    # the allocator restarts those keys' offsets from the view
    n, k, cap, s = 10, 6, 64, 2
    spec = jf.NemesisSpec(n_nodes=n, seed=5, crash=((2, 5, (0, 3, 7)),),
                          loss_rate=0.2, loss_until=9)
    sks, svs, crs = H.stage_kafka_ops(spec, 10, n_keys=k, max_sends=s)
    for amnesia in (False, True):
        jsim, psim = sims(n, k, cap, spec=spec, max_sends=s,
                          resync_mode=mode, kv_backend="device",
                          kv_amnesia=amnesia)
        drive(jsim, psim, sks, svs, crs, quiet=4)


def test_constructor_refusals():
    # tests/test_kvstore.py :298 (a dup stream on the device KV) and the
    # reference's argument checks
    dup = pf.NemesisSpec(n_nodes=4, seed=0, dup_rate=0.2,
                         dup_until=4).compile(device="cpu")
    with pytest.raises(ValueError, match="dup"):
        pk.KafkaSim(4, 2, 16, kv_backend="device", fault_plan=dup,
                    device="cpu")
    pk.KafkaSim(4, 2, 16, fault_plan=dup, device="cpu")   # host: accepted
    ok = pf.NemesisSpec(n_nodes=4, seed=0, loss_rate=0.2, loss_until=4,
                        crash=((1, 2, (0,)),)).compile(device="cpu")
    pk.KafkaSim(4, 2, 16, kv_backend="device", fault_plan=ok, device="cpu")
    with pytest.raises(ValueError, match="resync_mode"):
        pk.KafkaSim(4, 2, 8, resync_mode="gossip", device="cpu")
    with pytest.raises(ValueError, match="kv_amnesia"):
        pk.KafkaSim(4, 2, 8, kv_amnesia=True, device="cpu")
    with pytest.raises(ValueError, match="kv_backend"):
        pk.KafkaSim(4, 2, 8, kv_backend="disk", device="cpu")
    with pytest.raises(ValueError, match="FaultPlan is for 4"):
        pk.KafkaSim(5, 2, 8, fault_plan=ok, device="cpu")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("commits", (True, False))
def test_smoke_stage_kafka_ops_is_the_harness_staging(commits):
    # chip_smoke.py may not import the JAX package: it stages its Kafka
    # campaigns through the port's harness/nemesis.py, whose
    # stage_kafka_ops stages the reference's campaign (it keeps no copy)
    smoke = _smoke()
    assert not hasattr(smoke, "stage_kafka_ops")
    from gossip_glomers_tpu_torch.harness import nemesis as PN
    for n, seed in ((64, 2), (97, 5)):
        jspec = jf.random_spec(n, seed=seed, horizon=12, n_crash_windows=1,
                               loss_rate=0.1)
        pspec = pf.random_spec(n, seed=seed, horizon=12, n_crash_windows=1,
                               loss_rate=0.1)
        kw = dict(n_keys=16, max_sends=1, commits=commits)
        got = PN.stage_kafka_ops(pspec, 12, **kw)
        want = H.stage_kafka_ops(jspec, 12, **kw)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
