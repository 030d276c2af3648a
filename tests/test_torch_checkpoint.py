"""Checkpoints across the two packages, on the CPU, tolerance 0: for every
state class and mode (broadcast node-major with the delay ring and the
server ledger, node-major under a crash window, words-major with the
ring under the nemesis, the counter, Kafka with ``origin_bits``, ids and
echo) a file the reference writes restores in the port to the port's own
state, a file the port writes restores in the reference, both files hold
the same arrays (names, dtypes, shapes, values) and meta, and a run
resumed mid fault window from either file equals the uninterrupted run
of either package.  Then the reference's own checkpoint tests
(tests/test_aux_subsystems.py:98-136, tests/test_nemesis.py's mid-window
resume) and the refusals (a wrong class, a device-KV state)."""

import json

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import checkpoint as jck
from gossip_glomers_tpu.tpu_sim import counter as jco
from gossip_glomers_tpu.tpu_sim import echo as jec
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim import kafka as jka
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu.tpu_sim import unique_ids as jid
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import checkpoint as pck
from gossip_glomers_tpu_torch.tpu_sim import counter as pco
from gossip_glomers_tpu_torch.tpu_sim import echo as pec
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kafka as pka
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import txn as ptx
from gossip_glomers_tpu_torch.tpu_sim import unique_ids as pid

SAVE_AT, TOTAL = 5, 12
# a crash window open at the checkpoint round, loss through it
SPEC = dict(seed=3, crash=((3, 8, (1, 6)),), loss_rate=0.15, loss_until=9)


def _tree(n):
    return jtop.to_padded_neighbors(jtop.tree(n))


def bcast_nm_ring(n=32, nv=40):
    nbrs = _tree(n)
    delays = np.random.default_rng(5).integers(1, 4, nbrs.shape).astype(
        np.int32)
    inj = jbc.make_inject(n, nv)
    j = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=3, delays=delays)
    p = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=3, delays=delays,
                         device="cpu")
    return (j.init_state(inj), j.step, p.init_state(inj), p.step,
            "BroadcastState", None)


def bcast_nm_plan(n=32, nv=40):
    nbrs = _tree(n)
    inj = jbc.make_inject(n, nv)
    js, ps = jf.NemesisSpec(n_nodes=n, **SPEC), pf.NemesisSpec(n_nodes=n,
                                                              **SPEC)
    j = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=4,
                         fault_plan=js.compile(), srv_ledger=False)
    p = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=4,
                         fault_plan=ps.compile("cpu"), srv_ledger=False,
                         device="cpu")
    return (j.init_state(inj), j.step, p.init_state(inj), p.step,
            "BroadcastState", (js, ps))


def bcast_wm_ring(n=64, nv=40):
    nbrs = _tree(n)
    inj = jbc.make_inject(n, nv)
    js, ps = jf.NemesisSpec(n_nodes=n, **SPEC), pf.NemesisSpec(n_nodes=n,
                                                              **SPEC)
    j = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=4,
        exchange=jst.make_exchange("tree", n), fault_plan=js.compile(),
        srv_ledger=False,
        nemesis=jst.make_nemesis("tree", n, js, dir_delays=(1, 3)))
    p = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=4,
        exchange=pst.make_exchange("tree", n),
        fault_plan=ps.compile("cpu"), srv_ledger=False, device="cpu",
        nemesis=pst.make_nemesis("tree", n, ps, dir_delays=(1, 3),
                                 device="cpu"))
    return (j.init_state(inj), j.step, p.init_state(inj), p.step,
            "BroadcastState", (js, ps))


def counter(n=16):
    js, ps = jf.NemesisSpec(n_nodes=n, **SPEC), pf.NemesisSpec(n_nodes=n,
                                                              **SPEC)
    deltas = np.arange(1, n + 1, dtype=np.int32)
    j = jco.CounterSim(n, mode="cas", poll_every=2, fault_plan=js.compile())
    p = pco.CounterSim(n, mode="cas", poll_every=2,
                       fault_plan=ps.compile("cpu"), device="cpu")
    return (j.add(j.init_state(), deltas), j.step,
            p.add(p.init_state(), deltas), p.step, "CounterState", (js, ps))


def kafka_push(n=8, k=4, c=32, s=2):
    js, ps = jf.NemesisSpec(n_nodes=n, **SPEC), pf.NemesisSpec(n_nodes=n,
                                                              **SPEC)
    rng = np.random.default_rng(9)
    sks = rng.integers(-1, k, (TOTAL, n, s)).astype(np.int32)
    svs = rng.integers(0, 1000, (TOTAL, n, s)).astype(np.int32)
    crs = np.where(rng.random((TOTAL, n, k)) < 0.2, 2, -1).astype(np.int32)
    kw = dict(max_sends=s, resync_every=3, resync_mode="push")
    j = jka.KafkaSim(n, k, c, fault_plan=js.compile(), **kw)
    p = pka.KafkaSim(n, k, c, fault_plan=ps.compile("cpu"), device="cpu",
                     **kw)

    def jstep(st):
        t = int(st.t)
        return j.step(st, sks[t], svs[t], crs[t])

    def pstep(st):
        return p.step(st, sks[st.t], svs[st.t], crs[st.t])

    return (j.init_state(), jstep, p.init_state(), pstep, "KafkaState",
            (js, ps))


def ids(n=16):
    counts = np.random.default_rng(2).integers(0, 5, (TOTAL, n)).astype(
        np.int32)
    j = jid.UniqueIdsSim(n, max_per_round=4)
    p = pid.UniqueIdsSim(n, max_per_round=4, device="cpu")
    return (j.init_state(), lambda st: j.step(st, counts[int(st.t)])[0],
            p.init_state(), lambda st: p.step(st, counts[st.t])[0],
            "UniqueIdsState", None)


def echo(n=16):
    rng = np.random.default_rng(4)
    pay = rng.integers(0, 99, (TOTAL, n, 3)).astype(np.int32)
    val = rng.random((TOTAL, n, 3)) < 0.5
    j, p = jec.EchoSim(n), pec.EchoSim(n, device="cpu")
    return (j.init_state(), lambda st: j.step(st, pay[int(st.t)],
                                              val[int(st.t)])[0],
            p.init_state(), lambda st: p.step(st, pay[st.t], val[st.t])[0],
            "EchoState", None)


CASES = {"broadcast_node_major_ring_srv": bcast_nm_ring,
         "broadcast_node_major_plan": bcast_nm_plan,
         "broadcast_words_major_ring_nemesis": bcast_wm_ring,
         "counter": counter, "kafka_push_origin_bits": kafka_push,
         "ids": ids, "echo": echo}
CLASSES = {"BroadcastState": (jbc.BroadcastState, pbc.BroadcastState),
           "CounterState": (jco.CounterState, pco.CounterState),
           "KafkaState": (jka.KafkaState, pka.KafkaState),
           "UniqueIdsState": (jid.UniqueIdsState, pid.UniqueIdsState),
           "EchoState": (jec.EchoState, pec.EchoState)}


def ref_arrays(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if getattr(state, f) is not None}


def port_arrays(state) -> dict:
    """The port state in the reference's form (the checkpoint's table)."""
    return {f: pck._to_file(getattr(state, f), form)
            for f, form in pck._forms(type(state))
            if getattr(state, f) is not None}


def assert_arrays_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def run(step, state, rounds):
    for _ in range(rounds):
        state = step(state)
    return state


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_interchange_and_resume_equals_uninterrupted(case, tmp_path):
    j0, jstep, p0, pstep, cls, specs = CASES[case]()
    jcls, pcls = CLASSES[cls]
    jmid, pmid = run(jstep, j0, SAVE_AT), run(pstep, p0, SAVE_AT)
    assert_arrays_equal(ref_arrays(jmid), port_arrays(pmid))
    meta = {"case": case, "round": SAVE_AT}
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jck.save(jpath, jmid, meta, fault_spec=specs and specs[0])
    pck.save(ppath, pmid, meta, fault_spec=specs and specs[1])
    with np.load(jpath) as a, np.load(ppath) as b:
        fa, fb = {k: a[k] for k in a.files}, {k: b[k] for k in b.files}
    assert json.loads(bytes(fa.pop("__meta__"))) == json.loads(
        bytes(fb.pop("__meta__")))
    assert_arrays_equal(fa, fb)
    # each package restores the other's file to its own state
    p_from_j, pmeta = pck.restore(jpath, pcls, device="cpu")
    j_from_p, jmeta = jck.restore(ppath, jcls)
    assert pmeta == jmeta == {**meta, **({"fault_spec": specs[0].to_meta()}
                                         if specs else {})}
    assert_arrays_equal(port_arrays(p_from_j), port_arrays(pmid))
    assert_arrays_equal(ref_arrays(j_from_p), ref_arrays(jmid))
    if specs:
        assert pck.fault_spec_from_meta(pmeta).to_meta() == \
            specs[1].to_meta()
    # resumed on either side, both directions, equal the uninterrupted run
    jend = run(jstep, jmid, TOTAL - SAVE_AT)
    pend = run(pstep, pmid, TOTAL - SAVE_AT)
    want = ref_arrays(jend)
    assert_arrays_equal(port_arrays(pend), want)
    assert_arrays_equal(port_arrays(run(pstep, p_from_j, TOTAL - SAVE_AT)),
                        want)
    assert_arrays_equal(ref_arrays(run(jstep, j_from_p, TOTAL - SAVE_AT)),
                        want)


def test_checkpoint_resume_bit_exact(tmp_path):
    # tests/test_aux_subsystems.py:98-124 on the port
    n, nv = 64, 48
    sim = pbc.BroadcastSim(_tree(n), n_values=nv, device="cpu")
    inject = jbc.make_inject(n, nv)
    ref = run(sim.step, sim.init_state(inject), 6)
    st = run(sim.step, sim.init_state(inject), 3)
    path = str(tmp_path / "bcast.npz")
    pck.save(path, st, meta={"n_nodes": n, "round": 3})
    restored, meta = pck.restore(path, pbc.BroadcastState, device="cpu")
    assert meta == {"n_nodes": n, "round": 3}
    restored = run(sim.step, restored, 3)
    assert torch.equal(restored.received, ref.received)
    assert int(restored.msgs) == int(ref.msgs)
    assert restored.t == ref.t == 6


def test_resume_mid_fault_window_in_a_fresh_sim(tmp_path):
    # tests/test_nemesis.py's case: checkpoint at round 5 inside the
    # crash window [3, 8), resume in a sim rebuilt from the file's spec
    n, nv = 48, 48
    spec = pf.NemesisSpec(n_nodes=n, seed=11, crash=((3, 8, (2, 17, 40)),),
                          loss_rate=0.2, loss_until=10, dup_rate=0.1,
                          dup_until=10)
    inject = jbc.make_inject(n, nv)

    def fresh(sp):
        return pbc.BroadcastSim(_tree(n), n_values=nv, sync_every=4,
                                fault_plan=sp.compile("cpu"),
                                srv_ledger=False, device="cpu")

    sim = fresh(spec)
    ref = run(sim.step, sim.init_state(inject), 14)
    st = run(sim.step, sim.init_state(inject), 5)
    path = str(tmp_path / "mid_fault.npz")
    pck.save(path, st, {"round": 5}, fault_spec=spec)
    restored, meta = pck.restore(path, pbc.BroadcastState, device="cpu")
    back = pck.fault_spec_from_meta(meta)
    assert back.to_meta() == spec.to_meta() and meta["round"] == 5
    restored = run(fresh(back).step, restored, 9)
    for f in ("received", "frontier", "msgs"):
        assert torch.equal(getattr(restored, f), getattr(ref, f)), f
    assert restored.t == ref.t


def test_refusals_match_reference(tmp_path):
    # a wrong class (tests/test_aux_subsystems.py:127-136), in the
    # reference's words
    sim = pbc.BroadcastSim(_tree(8), n_values=4, device="cpu")
    path = str(tmp_path / "x.npz")
    pck.save(path, sim.init_state(jbc.make_inject(8, 4)))
    with pytest.raises(ValueError,
                       match="checkpoint holds BroadcastState, not "
                             "CounterState"):
        pck.restore(path, pco.CounterState, device="cpu")
    with pytest.raises(ValueError, match="not CounterState"):
        jck.restore(path, jco.CounterState)
    with pytest.raises(TypeError, match="no checkpoint form for object"):
        pck.save(path, object())


@pytest.mark.parametrize("kind", ["counter", "kafka", "txn"])
def test_device_kv_files_are_written_as_the_reference_and_refused(
        kind, tmp_path):
    # the device KV's rows go out as the reference's stacked (2, N, cap)
    # array; the port refuses to restore them (the reference hands the
    # stacked array back in place of a KVRows pair: ROADMAP.md Queue C)
    n = 8
    if kind == "counter":
        js = jco.CounterSim(n, kv_backend="device")
        ps = pco.CounterSim(n, kv_backend="device", device="cpu")
        d = np.arange(1, n + 1, dtype=np.int32)
        jst_, pst_ = (js.step(js.add(js.init_state(), d)),
                      ps.step(ps.add(ps.init_state(), d)))
        pcls = pco.CounterState
    elif kind == "kafka":
        js = jka.KafkaSim(n, 4, 16, kv_backend="device")
        ps = pka.KafkaSim(n, 4, 16, kv_backend="device", device="cpu")
        sk = np.tile(np.arange(4, dtype=np.int32)[None, :n], (n, 1))
        sv = np.arange(n * 4, dtype=np.int32).reshape(n, 4)
        jst_, pst_ = js.step(js.init_state(), sk, sv), ps.step(
            ps.init_state(), sk, sv)
        pcls = pka.KafkaState
    else:
        ps = ptx.TxnSim(n, 4, device="cpu")
        pst_, jst_, pcls = ps.step(ps.init_state()), None, ptx.TxnState
    ppath = str(tmp_path / "p.npz")
    pck.save(ppath, pst_, {"kind": kind})
    with np.load(ppath) as z:
        rows = z["rows"]
        assert rows.dtype == np.int32 and rows.shape[0] == 2
        np.testing.assert_array_equal(rows[0], pst_.rows.vals.numpy())
        np.testing.assert_array_equal(rows[1], pst_.rows.vers.numpy())
        if jst_ is not None:
            jpath = str(tmp_path / "j.npz")
            jck.save(jpath, jst_, {"kind": kind})
            with np.load(jpath) as w:
                assert sorted(w.files) == sorted(z.files)
                for f in w.files:
                    np.testing.assert_array_equal(w[f], z[f], err_msg=f)
    paths = [ppath] + ([str(tmp_path / "j.npz")] if jst_ is not None
                       else [])
    for path in paths:
        with pytest.raises(ValueError, match="device-KV"):
            pck.restore(path, pcls, device="cpu")


def test_device_put_hook_places_each_field(tmp_path):
    # the reference's device_put(field, array) hook: each array, in the
    # port's dtype, once; t stays a host int
    sim = pco.CounterSim(8, device="cpu")
    st = sim.run(sim.add(sim.init_state(), np.arange(8)), 3)
    path = str(tmp_path / "c.npz")
    pck.save(path, st)
    seen = []

    def put(name, arr):
        seen.append((name, arr.dtype))
        return torch.from_numpy(np.array(arr))

    back, _ = pck.restore(path, pco.CounterState, device_put=put)
    assert seen == [("pending", np.int32), ("cached", np.int32),
                    ("kv", np.int32), ("msgs", np.int64)]
    assert back.t == 3 and back.msgs.dtype == torch.int64
    assert_arrays_equal(port_arrays(back), port_arrays(st))
