"""Port parity for the device KV store (gossip_glomers_tpu_torch
tpu_sim/kvstore.py) against the JAX reference on the CPU: routing, the
static layout, the stale coin, the slab forms of the view and the masked
CAS / version-CAS / write, the amnesia row wipe, and the O(K) view and
CAS over the occupied slots against the slab forms; then the counter's device
backend against its host backend (tests/test_kvstore.py's cases).

Keys, rows and request batches come from seeded numpy and go to both
packages; every value compares exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim import kvstore as JKV
from gossip_glomers_tpu.tpu_sim.engine import collectives as jcoll
from gossip_glomers_tpu_torch.tpu_sim import counter as pc
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kvstore as KV
from gossip_glomers_tpu_torch.tpu_sim.engine import collectives


@pytest.mark.parametrize("n,seed", ((5, 0), (8, 3), (32, 11)))
def test_owner_routing_matches_reference(n, seed):
    keys = np.arange(257, dtype=np.int32)
    host = KV.host_owner_of(keys, n, seed)
    np.testing.assert_array_equal(host, JKV.host_owner_of(keys, n, seed))
    np.testing.assert_array_equal(
        KV.owner_of(torch.from_numpy(keys), n, seed).numpy(), host)
    assert host.min() >= 0 and host.max() < n


@pytest.mark.parametrize("n_keys,n,seed", ((40, 7, 2), (1, 5, 0),
                                           (300, 16, 9), (0, 3, 1)))
def test_make_layout_matches_reference(n_keys, n, seed):
    got, want = KV.make_layout(n_keys, n, seed=seed), \
        JKV.make_layout(n_keys, n, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # every key exactly once: the O(K) CAS rests on it
    assert int((got.key_at >= 0).sum()) == n_keys


@pytest.mark.parametrize("seed,t", ((0, 0), (3, 5), (123, 31),
                                    (2**32 - 1, 2**31 - 1)))
def test_stale_coin_matches_reference(seed, t):
    ids = np.arange(64, dtype=np.int32)
    host = KV.host_stale_coin(seed, t, ids)
    np.testing.assert_array_equal(host, JKV.host_stale_coin(seed, t, ids))
    np.testing.assert_array_equal(
        KV.stale_coin(seed, t, torch.from_numpy(ids)).numpy(), host)
    np.testing.assert_array_equal(
        host, np.asarray(JKV.stale_coin(seed, jnp.int32(t),
                                        jnp.asarray(ids))))
    assert KV.stale_num_of(0.0) == 0
    assert (host < KV.stale_num_of(1.0)).all()


def _rows_case(n, k, seed):
    rng = np.random.default_rng(seed)
    lay = KV.make_layout(k, n, seed=seed)
    vals = rng.integers(-5, 5, (n, lay.cap)).astype(np.int32)
    vers = rng.integers(0, 3, (n, lay.cap)).astype(np.int32)
    return lay, vals, vers, rng


def _np_rows(rows):
    return rows.vals.numpy(), rows.vers.numpy()


@pytest.mark.parametrize("n,k,seed", ((3, 6, 0), (7, 40, 2), (16, 5, 4)))
def test_slab_forms_match_reference(n, k, seed):
    lay, vals, vers, rng = _rows_case(n, k, seed)
    ka = torch.from_numpy(lay.key_at)
    jka = jnp.asarray(lay.key_at)
    prow = KV.KVRows(torch.from_numpy(vals), torch.from_numpy(vers))
    jrow = JKV.KVRows(jnp.asarray(vals), jnp.asarray(vers))
    coll, jc = collectives(n, device="cpu"), jcoll(n)
    np.testing.assert_array_equal(
        KV.rows_view(prow, ka, k, coll.reduce_sum).numpy(),
        np.asarray(JKV.rows_view(jrow, jka, k, jc.reduce_sum)))
    view = KV.rows_view(prow, ka, k, coll.reduce_sum)
    on = rng.random(k) < 0.6
    # frm hits about half the keys
    frm = np.where(rng.random(k) < 0.5, view[0].numpy(), 99).astype(np.int32)
    ver = np.where(rng.random(k) < 0.5, view[1].numpy(), 7).astype(np.int32)
    to = rng.integers(-100, 100, k).astype(np.int32)
    t_on, t_frm, t_ver, t_to = (torch.from_numpy(x) for x in (on, frm, ver,
                                                               to))
    j_on, j_frm, j_ver, j_to = (jnp.asarray(x) for x in (on, frm, ver, to))
    cases = [
        (KV.cas_apply(prow, ka, t_on, t_frm, t_to),
         JKV.cas_apply(jrow, jka, j_on, j_frm, j_to)),
        (KV.cas_ver_apply(prow, ka, t_on, t_ver, t_to),
         JKV.cas_ver_apply(jrow, jka, j_on, j_ver, j_to)),
        (KV.write_apply(prow, ka, t_on, t_to),
         JKV.write_apply(jrow, jka, j_on, j_to)),
    ]
    for got, want in cases:
        for a, b in zip(_np_rows(got), (np.asarray(want.vals),
                                        np.asarray(want.vers))):
            np.testing.assert_array_equal(a, b)
    # every update is out of place
    np.testing.assert_array_equal(prow.vals.numpy(), vals)
    # the O(K) CAS over the occupied slots equals the slab form, out of
    # place and on donated rows (written in place)
    slots = KV.key_slots(lay)
    want = _np_rows(cases[0][0])
    got = KV.cas_apply_at(prow, slots, t_on, t_frm, t_to)
    for a, b in zip(_np_rows(got), want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(prow.vals.numpy(), vals)
    donated = KV.KVRows(prow.vals.clone(), prow.vers.clone())
    got = KV.cas_apply_at(donated, slots, t_on, t_frm, t_to, donate=True)
    assert got.vals is donated.vals and got.vers is donated.vers
    for a, b in zip(_np_rows(got), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_keys,n,seed", ((40, 7, 2), (1, 5, 0),
                                           (300, 16, 9), (10_000, 8, 0),
                                           (256, 4096, 3)))
def test_rows_view_at_equals_rows_view(n_keys, n, seed):
    # the O(K) view (a gather of the key slots) is the slab view's (2, K)
    # values and versions on every layout, and the reference's
    lay, vals, vers, _ = _rows_case(n, n_keys, seed)
    prow = KV.KVRows(torch.from_numpy(vals), torch.from_numpy(vers))
    want = KV.rows_view(prow, torch.from_numpy(lay.key_at), n_keys,
                        collectives(n, device="cpu").reduce_sum)
    got = KV.rows_view_at(prow, KV.key_slots(lay))
    assert got.dtype == torch.int32 and got.shape == (2, n_keys)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JKV.rows_view(
            JKV.KVRows(jnp.asarray(vals), jnp.asarray(vers)),
            jnp.asarray(lay.key_at), n_keys, jcoll(n).reduce_sum)))


def test_cas_write_and_version_semantics():
    # tests/test_kvstore.py's scripted case on the port's slab forms
    n, k = 3, 6
    lay = KV.make_layout(k, n, seed=0)
    ka = torch.from_numpy(lay.key_at)
    coll = collectives(n, device="cpu")

    def view(rows):
        return KV.rows_view(rows, ka, k, coll.reduce_sum).numpy()

    rows = KV.init_rows(lay)
    assert view(rows).shape == (2, k) and (view(rows) == 0).all()
    on = torch.ones(k, dtype=torch.bool)
    rows = KV.write_apply(rows, ka, on, torch.full((k,), 7,
                                                   dtype=torch.int32))
    v = view(rows)
    assert (v[0] == 7).all() and (v[1] == 1).all()
    frm = torch.zeros(k, dtype=torch.int32)
    frm[2] = 7
    rows = KV.cas_apply(rows, ka, on, frm, torch.full((k,), 9,
                                                      dtype=torch.int32))
    v = view(rows)
    others = [i for i in range(k) if i != 2]
    assert v[0, 2] == 9 and v[1, 2] == 2
    assert (v[0, others] == 7).all() and (v[1, others] == 1).all()
    rows = KV.cas_ver_apply(rows, ka, on, torch.ones(k, dtype=torch.int32),
                            torch.full((k,), 11, dtype=torch.int32))
    v = view(rows)
    assert v[0, 2] == 9 and v[1, 2] == 2
    assert (v[0, others] == 11).all() and (v[1, others] == 2).all()
    assert (rows.vals.data_ptr() != rows.vers.data_ptr())


def test_rows_wipe_matches_reference():
    n, k = 4, 8
    kw = dict(n_nodes=n, seed=0, crash=((1, 3, (2,)),), join=((4, (1,)),))
    jplan = jf.NemesisSpec(**kw).compile()
    plan = pf.NemesisSpec(**kw).compile("cpu")
    lay = KV.make_layout(k, n, seed=1)
    vals = np.arange(n * lay.cap, dtype=np.int32).reshape(n, lay.cap) + 1
    prow = KV.KVRows(torch.from_numpy(vals), torch.ones(n, lay.cap,
                                                        dtype=torch.int32))
    jrow = JKV.KVRows(jnp.asarray(vals), jnp.ones((n, lay.cap), jnp.int32))
    ids = np.arange(n, dtype=np.int32)
    wiped = []
    for t in range(6):
        got = KV.rows_wipe(prow, plan, t, torch.from_numpy(ids))
        want = JKV.rows_wipe(jrow, jplan, jnp.int32(t), jnp.asarray(ids))
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
        np.testing.assert_array_equal(got.vers.numpy(), np.asarray(want.vers))
        wiped += [(t, i) for i in range(n) if (got.vals[i] == 0).all()]
    # node 2's restart edge and node 1's join, nothing else
    assert wiped == [(1, 2), (4, 1)]


def _pair(n, spec, **kw):
    return [pc.CounterSim(n, mode="cas", seed=7, device="cpu",
                          fault_plan=pf.NemesisSpec(**spec).compile("cpu"),
                          kv_backend=b, **kw) for b in ("host", "device")]


def test_counter_device_backend_equals_host_backend():
    # tests/test_kvstore.py's pin on the port: the device rows give the
    # host scalar's run round for round, and the store holds the value
    n, rounds = 8, 12
    spec = dict(n_nodes=n, seed=4, crash=((1, 3, (2,)),), loss_rate=0.2,
                loss_until=5)
    sims = _pair(n, spec, poll_every=2)
    deltas = np.arange(1, n + 1, dtype=np.int32)
    states = [s.add(s.init_state(), deltas) for s in sims]
    for t in range(rounds):
        states = [s.step(st) for s, st in zip(sims, states)]
        h, d = states
        for f in ("pending", "cached", "kv", "msgs"):
            assert torch.equal(getattr(h, f), getattr(d, f)), (t, f)
    assert int(states[1].kv) == int(deltas.sum()) - int(deltas[2])
    lay = sims[1]._kv_layout
    assert int(states[1].rows.vals[int(lay.owner[0]), int(lay.slot[0])]) \
        == int(states[1].kv)
    st_f = sims[1].run_fused(sims[1].add(sims[1].init_state(), deltas),
                             rounds)
    assert int(st_f.msgs) == int(states[1].msgs)
    assert int(st_f.kv) == int(states[1].kv)


def test_counter_kv_amnesia_loses_acked_flushes():
    # the crashed owner's register dies with it under kv_amnesia; the
    # durable default keeps every committed sum
    n = 6
    owner = int(KV.host_owner_of(np.array([0]), n, 7)[0])
    spec = pf.NemesisSpec(n_nodes=n, seed=2, crash=((1, 3, (owner,)),))
    durable, amnesic = (
        pc.CounterSim(n, mode="cas", poll_every=0, seed=7, device="cpu",
                      fault_plan=spec.compile("cpu"), kv_backend="device",
                      kv_amnesia=flag) for flag in (False, True))
    deltas = np.arange(1, n + 1, dtype=np.int32)
    deltas[owner] = 0
    std = durable.run(durable.add(durable.init_state(), deltas), n + 4)
    sta = amnesic.run(amnesic.add(amnesic.init_state(), deltas), n + 4)
    assert int(std.kv) == int(deltas.sum())
    assert 0 < int(sta.kv) < int(deltas.sum())


def test_device_backend_rejects_dup_streams():
    dup = pf.NemesisSpec(n_nodes=4, seed=0, dup_rate=0.2, dup_until=4)
    with pytest.raises(ValueError, match="dup"):
        KV.reject_dup_stream(dup.compile("cpu"), "here")
    KV.reject_dup_stream(None, "here")
    ok = pf.NemesisSpec(n_nodes=4, seed=0, loss_rate=0.2, loss_until=4,
                        crash=((1, 2, (0,)),))
    KV.reject_dup_stream(ok.compile("cpu"), "here")
    pc.CounterSim(4, mode="cas", kv_backend="device", device="cpu",
                  fault_plan=ok.compile("cpu"))


def test_collectives_off_mesh():
    coll = collectives(5, device="cpu")
    assert coll.row_ids.dtype == torch.int32
    assert coll.row_ids.tolist() == list(range(5))
    x = torch.arange(3)
    for f in ("widen", "reduce_sum", "reduce_max", "reduce_min",
              "reduce_or", "reduce_and", "local_cols"):
        assert getattr(coll, f)(x) is x
    assert (coll.exclusive_sum(x) == 0).all() and coll.axis_name is None
    assert tuple(coll._fields) == tuple(jcoll(5)._fields)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        collectives(5, mesh=object())
    # like every entry point, it runs on CUDA unless given a device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collectives(5)
