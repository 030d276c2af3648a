"""Elastic resizing on PyTorch against the reference, on the CPU,
tolerance 0: the cases of tests/test_membership.py:51-544 run through
both packages with their results held equal (the membership gates and
census, ``resize_spec``, ``resize_state`` on both layouts, the
checkpoint boundary, the re-homing diff and carry, the certified resize
campaigns of the three workloads, ``resizing_defer``, the sampler's
membership axis and the loud refusals).  The lint and audit cases
(:546-578) become checks that the program contracts raise Queue A item
14.  Campaign results are compared whole: they carry no wall-clock
field."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gossip_glomers_tpu.harness import membership as JHM
from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import checkpoint as jck
from gossip_glomers_tpu.tpu_sim import counter as jco
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import kafka as jka
from gossip_glomers_tpu.tpu_sim import kvstore as jkv
from gossip_glomers_tpu.tpu_sim import membership as JM
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu_torch.harness import membership as PHM
from gossip_glomers_tpu_torch.harness import serving as PSV
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import checkpoint as pck
from gossip_glomers_tpu_torch.tpu_sim import counter as pco
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import kafka as pka
from gossip_glomers_tpu_torch.tpu_sim import kvstore as pkv
from gossip_glomers_tpu_torch.tpu_sim import membership as PM
from gossip_glomers_tpu_torch.tpu_sim import scenario as PSC
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT


def both_specs(**kw):
    return JF.NemesisSpec(**kw), PF.NemesisSpec(**kw)


def bits(x) -> np.ndarray:
    """A port bitset tensor as the reference's uint32 array."""
    return x.numpy().view(np.uint32)


# -- membership columns: the gates and the census ------------------------


def test_membership_free_plan_is_noop():
    _, spec = both_specs(n_nodes=8, seed=1, crash=((2, 4, (1,)),))
    assert not spec.has_membership
    plan = spec.compile("cpu")
    assert (plan.join_round == PF.JOIN_FOUNDING).all()
    assert (plan.leave_round == PF.LEAVE_NEVER).all()
    ids = torch.arange(8)
    for t in range(8):
        assert PF.member_at(plan, t, ids).all()
        assert int(PM.member_census(plan, t, ids)) == 8
    assert int(PF.plan_churn(plan)) == 0
    assert not PF.NemesisSpec.from_meta(spec.to_meta()).has_membership


def test_member_gates_and_census_match_reference():
    kw = dict(n_nodes=8, seed=2, crash=((2, 5, (1, 6)),),
              join=((3, (6, 7)),), leave=((5, (0,)),))
    jspec, pspec = both_specs(**kw)
    jplan, pplan = jspec.compile(), pspec.compile("cpu")
    ids = np.arange(8)
    for t in range(10):
        np.testing.assert_array_equal(
            PF.member_at(pplan, t, torch.from_numpy(ids)).numpy(),
            np.asarray(JF.member_at(jplan, t, ids)))
        want = int(JM.member_census(jplan, t, jnp.asarray(ids),
                                    lambda x: x))
        got = PM.member_census(pplan, t, torch.from_numpy(ids))
        assert got.dtype == torch.int32 and int(got) == want, t
        assert int(PM.member_census(pplan, t, torch.from_numpy(ids),
                                    lambda x: x * 2)) == 2 * want
    assert int(PF.plan_churn(pplan)) == int(JF.plan_churn(jplan)) == 3


# -- resize_spec ---------------------------------------------------------


@pytest.mark.parametrize("kw,n_to,r", [
    (dict(n_nodes=8, seed=3, crash=((4, 9, (1, 2)),)), 12, 6),
    (dict(n_nodes=12, seed=5, crash=((4, 9, (1, 10)),),
          leave=((3, (8, 9, 10, 11)),)), 8, 6),
    (dict(n_nodes=8, seed=4, loss_rate=0.1, loss_until=7, dup_rate=0.05,
          dup_until=5, join=((2, (6,)),)), 16, 3),
    (dict(n_nodes=16, seed=6, crash=((1, 3, (2, 14)),), loss_rate=0.2,
          join=((2, (12,)),), leave=((4, (12, 13, 14, 15)), )), 12, 5),
], ids=["grow", "shrink", "grow_rates", "shrink_join_crash"])
def test_resize_spec_matches_reference(kw, n_to, r):
    jspec, pspec = both_specs(**kw)
    got = PM.resize_spec(pspec, n_to, r)
    assert got.to_meta() == JM.resize_spec(jspec, n_to, r).to_meta()
    assert got.n_nodes == n_to
    if n_to > kw["n_nodes"]:
        assert got.join[-1] == (r, tuple(range(kw["n_nodes"], n_to)))
        assert not got.host_members(r - 1)[kw["n_nodes"]:].any()
        assert got.host_members(r)[kw["n_nodes"]:].all()


def test_resize_spec_refusals_match_reference():
    jlive, plive = both_specs(n_nodes=12, seed=5, crash=((4, 9, (1,)),))
    jspec, pspec = both_specs(n_nodes=12, seed=5, crash=((4, 9, (1, 10)),),
                              leave=((3, (8, 9, 10, 11)),))
    for args, pat in (((plive, 8, 6), r"rows \[8, 9, 10, 11\] are still "
                                      "members"),
                      ((pspec, 8, 0), "resize_round must be >= 1"),
                      ((pspec, 12, 6), "same capacity")):
        jargs = ({id(plive): jlive, id(pspec): jspec}[id(args[0])],) \
            + args[1:]
        with pytest.raises(ValueError) as pe:
            PM.resize_spec(*args)
        with pytest.raises(ValueError) as je:
            JM.resize_spec(*jargs)
        assert str(pe.value) == str(je.value)
        assert pytest.raises(ValueError, PM.resize_spec, *args).match(pat)


# -- resize_state: both layouts, every state, the refusals ---------------


def _full_pair(n, nv, **kw):
    nbrs = jtop.to_padded_neighbors(jtop.full(n))
    inj = jbc.make_inject(n, nv)
    j = jbc.BroadcastSim(nbrs, n_values=nv, **kw)
    p = pbc.BroadcastSim(nbrs, n_values=nv, device="cpu", **kw)
    return j.stage(inj)[0], p.stage(inj)[0]


@pytest.mark.parametrize("n_to", [12, 6])
def test_resize_state_node_major_matches_reference(n_to):
    jst_, pst_ = _full_pair(8, 40)
    jst_, pst_ = jst_._replace(t=jnp.int32(3)), pbc.BroadcastState(
        received=pst_.received, frontier=pst_.frontier, t=3,
        msgs=pst_.msgs + 5, srv_msgs=pst_.srv_msgs)
    jst_ = jst_._replace(msgs=jst_.msgs + 5)
    got, want = PM.resize_state(pst_, n_to), JM.resize_state(jst_, n_to)
    for f in ("received", "frontier"):
        np.testing.assert_array_equal(bits(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
        assert getattr(got, f).is_contiguous()
    assert got.received.shape[0] == n_to
    assert got.t == int(want.t) == 3 and int(got.msgs) == int(want.msgs)
    assert got.srv_msgs is pst_.srv_msgs
    if n_to < 8:   # a fresh tensor, not a view of the old one
        assert got.received.untyped_storage().data_ptr() != \
            pst_.received.untyped_storage().data_ptr()


def test_resize_state_words_major_pads_the_words_axis_as_the_reference():
    # the reference's node-axis map gives axis 0 for received / frontier;
    # a words-major (W, N) state is padded on its words axis, in both
    # packages (ROADMAP.md Queue C)
    n, nv = 16, 40
    nbrs = jtop.to_padded_neighbors(jtop.tree(n))
    inj = jbc.make_inject(n, nv)
    j = jbc.BroadcastSim(nbrs, n_values=nv,
                         exchange=jst.make_exchange("tree", n))
    p = pbc.BroadcastSim(nbrs, n_values=nv, device="cpu",
                         exchange=pst.make_exchange("tree", n))
    jst_, pst_ = j.stage(inj)[0], p.stage(inj)[0]
    assert pst_.received.shape == (2, n)
    for n_to in (24, 1):
        got, want = PM.resize_state(pst_, n_to), JM.resize_state(jst_, n_to)
        assert got.received.shape == np.asarray(want.received).shape == \
            (n_to, n)
        for f in ("received", "frontier"):
            np.testing.assert_array_equal(bits(getattr(got, f)),
                                          np.asarray(getattr(want, f)))


def test_resize_state_counter_and_kafka_match_reference():
    n = 8
    d = np.arange(1, n + 1, dtype=np.int32)
    j, p = jco.CounterSim(n), pco.CounterSim(n, device="cpu")
    jc, pc = j.step(j.add(j.init_state(), d)), p.step(p.add(
        p.init_state(), d))
    jk_ = jka.KafkaSim(n, 3, 40, max_sends=2, resync_mode="push")
    pk_ = pka.KafkaSim(n, 3, 40, max_sends=2, resync_mode="push",
                       device="cpu")
    sk = np.random.default_rng(1).integers(-1, 3, (n, 2)).astype(np.int32)
    sv = np.arange(2 * n, dtype=np.int32).reshape(n, 2)
    jk, pk = jk_.step(jk_.init_state(), sk, sv), pk_.step(pk_.init_state(),
                                                        sk, sv)
    for n_to in (12, 5):
        a, b = PM.resize_state(pc, n_to), JM.resize_state(jc, n_to)
        for f in ("pending", "cached", "kv"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
        a, b = PM.resize_state(pk, n_to), JM.resize_state(jk, n_to)
        for f in ("present", "origin_bits"):
            np.testing.assert_array_equal(bits(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
        for f in ("local_committed", "log_vals", "kv_val"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))


def test_resize_state_refusals_match_reference():
    import collections

    n, nv = 8, 16
    nbrs = jtop.to_padded_neighbors(jtop.full(n))
    jd, pd = _full_pair(n, nv, delays=np.full(nbrs.shape, 2, np.int32))
    jc = jco.CounterSim(n, kv_backend="device")
    pc = pco.CounterSim(n, kv_backend="device", device="cpu")
    Foo = collections.namedtuple("FooState", ["x"])
    for got, want, pat in (
            (pd, jd, "delay ring"),
            (pc.init_state(), jc.init_state(), "apply_rehoming"),
            (Foo(x=torch.zeros(4)), Foo(x=jnp.zeros(4)),
             "no node-axis resize map")):
        with pytest.raises(ValueError, match=pat) as pe:
            PM.resize_state(got, 12)
        with pytest.raises(ValueError) as je:
            JM.resize_state(want, 12)
        assert str(pe.value) == str(je.value)


# -- restore_resized: the checkpoint boundary ----------------------------


def test_restore_resized_across_packages(tmp_path):
    n, nv = 8, 16
    jspec, pspec = both_specs(n_nodes=n, seed=3, crash=((4, 9, (1, 2)),))
    nbrs = jtop.to_padded_neighbors(jtop.full(n))
    inj = jbc.make_inject(n, nv)
    j = jbc.BroadcastSim(nbrs, n_values=nv, fault_plan=jspec.compile())
    jstate = j.run_staged_fixed(j.stage(inj)[0], 5)
    bare, ck = str(tmp_path / "bare.npz"), str(tmp_path / "ck.npz")
    jck.save(bare, jstate, meta={"workload": "broadcast"})
    with pytest.raises(ValueError, match="no fault_spec"):
        PM.restore_resized(bare, pbc.BroadcastState, 12, device="cpu")
    jck.save(ck, jstate, meta={"workload": "broadcast"}, fault_spec=jspec)
    st, sp, meta = PM.restore_resized(ck, pbc.BroadcastState, 12,
                                      device="cpu")
    jst2, jsp, jmeta = JM.restore_resized(ck, jbc.BroadcastState, 12)
    np.testing.assert_array_equal(bits(st.received),
                                  np.asarray(jst2.received))
    assert sp.to_meta() == jsp.to_meta() and meta == jmeta
    assert sp.join[-1] == (5, (8, 9, 10, 11)) and st.t == 5
    # a port-written checkpoint across the boundary in the reference
    p = pbc.BroadcastSim(nbrs, n_values=nv, device="cpu",
                         fault_plan=pspec.compile("cpu"))
    pstate = p.run_staged_fixed(p.stage(inj)[0], 5)
    pck.save(ck, pstate, meta={"workload": "broadcast"}, fault_spec=pspec)
    jst3, jsp3, _ = JM.restore_resized(ck, jbc.BroadcastState, 12)
    np.testing.assert_array_equal(bits(st.received),
                                  np.asarray(jst3.received))
    assert jsp3.to_meta() == sp.to_meta()


# -- KV re-homing: host twin == device mask, the carry -------------------


@pytest.mark.parametrize("n_from,n_to", [(8, 12), (12, 8), (8, 16), (8, 8)])
def test_rehoming_diff_matches_reference(n_from, n_to):
    moved = PM.rehomed_keys(256, n_from, n_to)
    np.testing.assert_array_equal(moved, JM.rehomed_keys(256, n_from, n_to))
    mask = PM.rehomed_mask(256, n_from, n_to, device="cpu")
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(JM.rehomed_mask(256, n_from, n_to)))
    np.testing.assert_array_equal(moved, torch.nonzero(mask)[:, 0].numpy())
    keys = np.arange(256, dtype=np.int32)
    ow_a = pkv.host_owner_of(keys, n_from)
    ow_b = pkv.host_owner_of(keys, n_to)
    assert (ow_a[moved] != ow_b[moved]).all()
    assert (ow_a[np.setdiff1d(keys, moved)]
            == ow_b[np.setdiff1d(keys, moved)]).all()
    assert (moved.size == 0) == (n_from == n_to)
    for seed in (0, 5):
        np.testing.assert_array_equal(
            PM.rehomed_mask(64, n_from, n_to, seed, device="cpu").numpy(),
            np.asarray(JM.rehomed_mask(64, n_from, n_to, seed)))


def test_apply_rehoming_matches_reference():
    n_keys = 64
    lo, ln = pkv.make_layout(n_keys, 8), pkv.make_layout(n_keys, 12)
    jlo, jln = jkv.make_layout(n_keys, 8), jkv.make_layout(n_keys, 12)
    keys = np.arange(n_keys)
    vals = np.zeros((8, lo.cap), np.int32)
    vers = np.zeros((8, lo.cap), np.int32)
    vals[lo.owner, lo.slot] = keys * 5 + 2
    vers[lo.owner, lo.slot] = keys % 3
    rows = pkv.KVRows(torch.from_numpy(vals), torch.from_numpy(vers))
    got = PM.apply_rehoming(rows, lo, ln)
    want = JM.apply_rehoming(jkv.KVRows(jnp.asarray(vals),
                                        jnp.asarray(vers)), jlo, jln)
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(got.vers.numpy(), np.asarray(want.vers))
    assert got.vals.dtype == torch.int32
    np.testing.assert_array_equal(got.vals.numpy()[ln.owner, ln.slot],
                                  keys * 5 + 2)
    for bad, pat in ((pkv.make_layout(32, 12), "key space"),
                     (pkv.make_layout(n_keys, 12, seed=1), "routing seed")):
        with pytest.raises(ValueError, match=pat):
            PM.apply_rehoming(rows, lo, bad)


# -- certified resize campaigns, against the reference -------------------


CAMPAIGNS = {
    # tests/test_membership.py:242-329
    "broadcast_grow": ("broadcast", dict(n_nodes=8, seed=3,
                                         crash=((4, 9, (1, 2)),)), 12, 6,
                       dict(kv_keys=128, max_recovery_rounds=48)),
    "broadcast_shrink": ("broadcast", dict(
        n_nodes=12, seed=5, crash=((4, 9, (1,)),),
        leave=((3, (8, 9, 10, 11)),)), 8, 6,
        dict(kv_keys=128, max_recovery_rounds=48)),
    "counter_grow": ("counter", dict(n_nodes=8, seed=3,
                                     crash=((10, 15, (1, 2)),)), 12, 12,
                     dict(max_recovery_rounds=48)),
    "counter_shrink": ("counter", dict(
        n_nodes=12, seed=5, crash=((16, 21, (1,)),),
        leave=((16, (8, 9, 10, 11)),)), 8, 18,
        dict(max_recovery_rounds=48)),
    "counter_early_leave": ("counter", dict(
        n_nodes=12, seed=5, crash=((4, 9, (1,)),),
        leave=((3, (8, 9, 10, 11)),)), 8, 6,
        dict(twin=False, max_recovery_rounds=48)),
    "counter_allreduce_grow": ("counter", dict(
        n_nodes=64, seed=2, crash=((10, 15, (1, 2)),)), 128, 12,
        dict(mode="allreduce", max_recovery_rounds=48, kv_keys=512,
             deltas=np.random.default_rng(0).integers(0, 10, 64).astype(
                 np.int32))),
    "kafka_grow": ("kafka", dict(n_nodes=8, seed=7,
                                 crash=((4, 9, (1, 2)),)), 12, 6,
                   dict(max_recovery_rounds=48)),
    "kafka_shrink": ("kafka", dict(
        n_nodes=12, seed=9, crash=((4, 9, (1,)),),
        leave=((3, (8, 9, 10, 11)),)), 8, 6, dict(max_recovery_rounds=48)),
}


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_resize_campaign_matches_reference(name):
    wl, kw, n_to, r, ckw = CAMPAIGNS[name]
    jspec, pspec = both_specs(**kw)
    want = JHM.run_resize_campaign(wl, jspec, n_to, r, **ckw)
    got = PHM.run_resize_campaign(wl, pspec, n_to, r, device="cpu", **ckw)
    assert got == want
    if name == "counter_early_leave":
        assert not got["ok"] and got["lost_writes"][0]["lost_sum"] > 0
    else:
        assert got["ok"], got
        assert got["lost_writes"] == []
    if wl == "kafka":
        assert got["twin"]["bit_exact"] is None
        assert "certified-only" in got["twin"]["reason"]
        assert got["n_allocated"] >= got["n_allocated_pre_resize"] > 0
    elif name != "counter_early_leave":
        assert got["twin"]["bit_exact"] is True
        assert got["twin"]["rows_compared"] == n_to
    if "kv_keys" in ckw:
        assert got["rehoming"]["ok"] and got["rehoming"]["n_moved"] > 0


def test_resize_campaign_keeps_its_checkpoint(tmp_path):
    # checkpoint_dir keeps the file; it restores in the reference
    spec = PF.NemesisSpec(n_nodes=8, seed=3, crash=((10, 15, (1, 2)),))
    res = PHM.run_resize_campaign("counter", spec, 12, 12, device="cpu",
                                  checkpoint_dir=str(tmp_path),
                                  max_recovery_rounds=48)
    assert res["ok"]
    path = os.path.join(str(tmp_path), "resize_counter_8to12.npz")
    st, meta = jck.restore(path, jco.CounterState)
    assert int(st.t) == 12 and meta["workload"] == "counter"
    assert JF.NemesisSpec.from_meta(meta["fault_spec"]).to_meta() == \
        spec.to_meta()


def test_resize_campaign_refusals_match_reference():
    jspec, pspec = both_specs(n_nodes=8, seed=1)
    for args, pat in ((("txn", 12, 4), "txn"),
                      (("broadcast", 12, 4), "topology 'full' only")):
        kw = {"topology": "grid"} if args[0] == "broadcast" else {}
        with pytest.raises(ValueError, match=pat) as pe:
            PHM.run_resize_campaign(args[0], pspec, *args[1:], device="cpu",
                                    **kw)
        with pytest.raises(ValueError) as je:
            JHM.run_resize_campaign(args[0], jspec, *args[1:], **kw)
        assert str(pe.value) == str(je.value)


# -- traffic: the resizing backpressure class ----------------------------


def test_resizing_defer_matches_reference():
    kw = dict(n_nodes=4, n_clients=8, ops_per_client=2, until=4)
    jts = JT.init_state(JT.TrafficSpec(**kw))
    pts = PT.init_state(PT.TrafficSpec(**kw), device="cpu")
    arr = np.array([1, 0, 1, 1, 1, 0, 1, 1], bool)
    jts, jok = JT.resizing_defer(jts, jnp.asarray(arr), lambda x: x)
    pts, pok = PT.resizing_defer(pts, torch.from_numpy(arr))
    assert pok.dtype == torch.bool and not pok.any()
    assert pok.shape == np.asarray(jok).shape
    for f in ("arrived", "deferred", "deferred_resizing"):
        assert int(getattr(pts, f)) == int(getattr(jts, f)) == 6, f
    assert (pts.issued_k == 0).all()
    pts, _ = PT.resizing_defer(pts, arr, lambda x: x * 0)
    assert int(pts.arrived) == 6
    # issuance past the boundary: the sub-class never exceeds its parent
    pts2, ok2, _k = PT.issue(pts, torch.ones(8, dtype=torch.bool),
                             torch.ones(8, dtype=torch.bool), 1)
    assert bool(ok2.all())
    assert int(pts2.deferred_resizing) <= int(pts2.deferred)
    assert int(pts2.arrived) == 14


# -- loud refusals on unsupported paths ----------------------------------


def test_membership_plans_rejected_loudly_everywhere():
    mem = PF.NemesisSpec(n_nodes=8, seed=1, join=((2, (6, 7)),))
    with pytest.raises(ValueError, match="membership"):
        pst.make_nemesis("grid", 8, mem, device="cpu")
    tspec = PT.TrafficSpec(n_nodes=8, n_clients=8, ops_per_client=2,
                           until=4)
    with pytest.raises(ValueError, match="membership"):
        PSV.run_serving("broadcast", tspec, nemesis=mem, device="cpu")
    cell = PSC.ServingCell(traffic=tspec, spec=mem)
    sbatch = PSC.ServingBatch(workload="broadcast", cells=(cell,),
                              runner_kw={"n_values": 16, "sync_every": 4})
    with pytest.raises(ValueError,
                       match="serving cell 0 carries membership"):
        PSC.run_serving_batch(sbatch, device="cpu")
    tbatch = PSC.ScenarioBatch(workload="txn",
                               scenarios=(PSC.Scenario(spec=mem),))
    with pytest.raises(ValueError,
                       match="txn scenario 0 carries membership"):
        PSC.run_scenario_batch(tbatch, device="cpu")


def test_program_contracts_raise_item_14():
    # tests/test_membership.py:546-578 (the lint split and the sharded
    # census contracts) have no PyTorch meaning yet
    with pytest.raises(NotImplementedError, match="item 14"):
        PM.audit_contracts()
