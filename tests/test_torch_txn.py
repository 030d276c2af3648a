"""Port parity for txn-rw-register: gossip_glomers_tpu_torch's ``TxnSim``,
its round kernels' plain versions, ``run_txn_nemesis`` and the copied
``check_txn_serializable`` against the JAX reference on the CPU.

The reference's tests/test_txn.py cases run on the port (the clean run,
step / run / run_fused, the certified campaign, the kv_amnesia failure
with its flight bundle, the telemetry refusal, every planted checker
anomaly), and a seeded random probe holds the state and history equal
to the reference's at every round: 1-33 nodes, 1-40 keys, T 1-6, O up to
min(K, 4), rates 0.1-1.0, crash and loss plans (the loss coins also
drop KV exchanges) with kv_amnesia on and off, and starts from a
reference mid-run state.  Inputs come from seeded numpy; every
comparison is exact (tolerance 0).
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import checkers as JC
from gossip_glomers_tpu.harness import observe as JO
from gossip_glomers_tpu.harness import txn as JH
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import kvstore as JKV
from gossip_glomers_tpu.tpu_sim import txn as JT
from gossip_glomers_tpu_torch.harness import checkers as PC
from gossip_glomers_tpu_torch.harness import observe as PO
from gossip_glomers_tpu_torch.harness import txn as PH
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import kvstore as PKV
from gossip_glomers_tpu_torch.tpu_sim import txn as PT


def _norm(x):
    """A result as plain JSON-like data (numpy arrays to lists)."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.integer):
        return int(x)
    return x


def assert_same_result(want: dict, got: dict) -> None:
    want, got = _norm(want), _norm(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


def _port_plan(jplan):
    return PF.plan_from_numpy(**{k: np.asarray(v)
                                 for k, v in jplan._asdict().items()})


def _sims(n, k, spec=None, **kw):
    """(JAX, port) TxnSims of the same arguments; ``spec`` a NemesisSpec's
    kwargs."""
    jkw, pkw = dict(kw), dict(kw)
    if spec is not None:
        jplan = JF.NemesisSpec(**spec).compile()
        jkw["fault_plan"] = jplan
        pkw["fault_plan"] = _port_plan(jplan)
    return JT.TxnSim(n, k, **jkw), PT.TxnSim(n, k, device="cpu", **pkw)


FIELDS = ("arrived", "cur", "issue", "issue_round", "commit_round",
          "op_ver", "op_val")


def _same(js, ps, where=""):
    assert ps.t == int(js.t), where
    assert int(ps.msgs) == int(js.msgs), where
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{f} {where}")
    np.testing.assert_array_equal(ps.rows.vals.numpy(),
                                  np.asarray(js.rows.vals))
    np.testing.assert_array_equal(ps.rows.vers.numpy(),
                                  np.asarray(js.rows.vers))


def _drive(jsim, psim, rounds, js=None, ps=None):
    """Both sims round by round, equal after every round and in their
    histories and final registers; returns the final states."""
    js = jsim.init_state() if js is None else js
    ps = psim.init_state() if ps is None else ps
    for r in range(rounds):
        js, ps = jsim.step(js), psim.step(ps)
        _same(js, ps, f"round {r}")
    assert PT.history_of(ps, psim.ops) == JT.history_of(js, jsim.ops)
    assert PT.final_registers(ps, psim.layout) \
        == JT.final_registers(js, jsim.layout)
    return js, ps


# -- the staged workload and the KV's O(K) version CAS --------------------


@pytest.mark.parametrize("n,t_dim,o,k,seed", [
    (8, 4, 2, 8, 0), (13, 3, 4, 5, 11), (1, 6, 1, 1, 3), (33, 2, 3, 40, 7)])
def test_stage_txn_ops_matches_reference(n, t_dim, o, k, seed):
    want = JT.stage_txn_ops(n, t_dim, o, k, seed)
    got = PT.stage_txn_ops(n, t_dim, o, k, seed)
    for f in ("keys", "write", "wval"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.keys.dtype == torch.int32 and got.write.dtype == torch.bool
    # the cache hands out copies: a caller's change stays its own
    got.keys[0, 0, 0] += 1
    again = PT.stage_txn_ops(n, t_dim, o, k, seed)
    np.testing.assert_array_equal(again.keys.numpy(), np.asarray(want.keys))
    with pytest.raises(ValueError, match="distinct"):
        PT.stage_txn_ops(n, t_dim, k + 1, k, seed)


@pytest.mark.parametrize("n_keys,n,seed", ((40, 7, 2), (1, 5, 0),
                                           (300, 16, 9)))
def test_cas_ver_apply_at_equals_slab_form(n_keys, n, seed):
    rng = np.random.default_rng(seed)
    lay = PKV.make_layout(n_keys, n, seed=seed)
    vals = rng.integers(-50, 50, (n, lay.cap)).astype(np.int32)
    vers = rng.integers(0, 4, (n, lay.cap)).astype(np.int32)
    rows = PKV.KVRows(torch.from_numpy(vals), torch.from_numpy(vers))
    on = torch.from_numpy(rng.random(n_keys) < 0.6)
    ver = torch.from_numpy(rng.integers(0, 4, n_keys).astype(np.int32))
    val = torch.from_numpy(rng.integers(-9, 9, n_keys).astype(np.int32))
    ka = torch.from_numpy(lay.key_at)
    want = PKV.cas_ver_apply(rows, ka, on, ver, val)
    jwant = JKV.cas_ver_apply(JKV.KVRows(jnp.asarray(vals), jnp.asarray(vers)),
                              jnp.asarray(lay.key_at), jnp.asarray(on.numpy()),
                              jnp.asarray(ver.numpy()),
                              jnp.asarray(val.numpy()))
    slots = PKV.key_slots(lay)
    got = PKV.cas_ver_apply_at(rows, slots, on, ver, val)
    np.testing.assert_array_equal(rows.vals.numpy(), vals)   # out of place
    donated = PKV.KVRows(rows.vals.clone(), rows.vers.clone())
    got_d = PKV.cas_ver_apply_at(donated, slots, on, ver, val, donate=True)
    assert got_d.vals is donated.vals and got_d.vers is donated.vers
    for g in (got, got_d):
        for a, b, c in ((g.vals, want.vals, jwant.vals),
                        (g.vers, want.vers, jwant.vers)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


# -- the round kernels' plain versions against the reference's XLA code ---


def _reference_round_core(keys, write, wval, cur, issue, active, vals,
                          vers, key_at, op_ver, op_val, commit_round,
                          issue_round, t, k):
    """txn.py _round :264-322 as the reference writes it (jnp, int32),
    from the liveness and arrivals on: (best, req, cur, issue, op_ver,
    op_val, commit_round, issue_round)."""
    n, t_dim, o = keys.shape
    keys, write, wval = (jnp.asarray(x) for x in (keys, write, wval))
    cur, issue_old = jnp.asarray(cur), jnp.asarray(issue)
    active = jnp.asarray(active)
    t = jnp.int32(t)
    issue = jnp.where(active & (issue_old < 0), t, issue_old)
    row_ids = jnp.arange(n, dtype=jnp.int32)
    curc = jnp.clip(cur, 0, t_dim - 1)
    sel = curc[:, None, None]
    keys_n = jnp.take_along_axis(keys, sel, axis=1)[:, 0]
    wr_n = jnp.take_along_axis(write, sel, axis=1)[:, 0]
    wv_n = jnp.take_along_axis(wval, sel, axis=1)[:, 0]
    prio = issue * jnp.int32(n) + row_ids
    claim = jnp.where(active[:, None],
                      jnp.broadcast_to(prio[:, None], keys_n.shape),
                      jnp.int32(kernels.TXN_INF))
    best = jnp.full((k,), kernels.TXN_INF, jnp.int32).at[keys_n.ravel()].min(
        claim.ravel())
    win = active & jnp.all(best[keys_n] == prio[:, None], axis=1)
    ka = jnp.asarray(key_at)
    occ = ka >= 0
    idx = jnp.where(occ, ka, 0).ravel()
    vals_k = jnp.zeros((k,), jnp.int32).at[idx].add(
        jnp.where(occ, jnp.asarray(vals), 0).ravel())
    vers_k = jnp.zeros((k,), jnp.int32).at[idx].add(
        jnp.where(occ, jnp.asarray(vers), 0).ravel())
    rd_val, rd_ver = vals_k[keys_n], vers_k[keys_n]
    w_mask = win[:, None] & wr_n
    req = jnp.stack([
        jnp.zeros((k,), jnp.int32).at[keys_n.ravel()].add(
            w_mask.astype(jnp.int32).ravel()),
        jnp.zeros((k,), jnp.int32).at[keys_n.ravel()].add(
            jnp.where(w_mask, wv_n, 0).ravel()),
        jnp.zeros((k,), jnp.int32).at[keys_n.ravel()].add(
            jnp.where(w_mask, rd_ver, 0).ravel())])
    ar = jnp.arange(n, dtype=jnp.int32)
    slot_w = jnp.where(win, curc, jnp.int32(t_dim))
    new_ver = jnp.where(wr_n, rd_ver + 1, rd_ver)
    new_val = jnp.where(wr_n, wv_n, rd_val)
    oi = jnp.arange(o)[None, :]
    op_ver = jnp.asarray(op_ver).at[ar[:, None], slot_w[:, None], oi].set(
        new_ver, mode="drop")
    op_val = jnp.asarray(op_val).at[ar[:, None], slot_w[:, None], oi].set(
        new_val, mode="drop")
    commit_round = jnp.asarray(commit_round).at[ar, slot_w].set(
        t, mode="drop")
    first = active & (issue_old < 0)
    slot_f = jnp.where(first, curc, jnp.int32(t_dim))
    issue_round = jnp.asarray(issue_round).at[ar, slot_f].set(t,
                                                              mode="drop")
    return (best, req, cur + win.astype(jnp.int32),
            jnp.where(win, jnp.int32(-1), issue), op_ver, op_val,
            commit_round, issue_round, jnp.sum(active.astype(jnp.int32)))


@pytest.mark.parametrize("n,o,k,wrap", [
    (1, 1, 1, False), (31, 2, 5, True), (37, 4, 40, True), (64, 3, 9, True),
    (257, 1, 3, False), (33, 2, 7, False)])
def test_plain_kernels_match_reference_xla_code(n, o, k, wrap):
    # random inputs (keys need not be distinct), issue stamps whose
    # priorities wrap int32, and at odd n two nodes planted to share a
    # wrapped priority and their keys (both win: the requests add)
    rng = np.random.default_rng(n * 7 + o)
    t_dim = 3
    keys = rng.integers(0, k, (n, t_dim, o)).astype(np.int32)
    write = rng.random((n, t_dim, o)) < 0.5
    wval = rng.integers(-(1 << 31), 1 << 31, (n, t_dim, o)).astype(np.int32)
    cur = rng.integers(0, t_dim + 1, n).astype(np.int32)
    lo = -(-(1 << 31) // n) if wrap else 0
    issue = rng.integers(lo, (1 << 31) - 1 if wrap else 64, n)
    issue = np.where(rng.random(n) < 0.25, -1, issue).astype(np.int32)
    active = rng.random(n) < 0.7
    if wrap and n % 2:
        inv = pow(n, -1, 1 << 32)
        for j in range(64):
            ia, ib = ((((1 << 31) + j - x) * inv) % (1 << 32)
                      for x in (0, 1))
            if ia < 1 << 31 and ib < 1 << 31:
                issue[0], issue[1] = ia, ib
                cur[0] = cur[1] = 0
                keys[1, 0] = keys[0, 0]
                active[:2] = True
                break
    lay = PKV.make_layout(k, n, seed=n)
    vals = rng.integers(-(1 << 31), 1 << 31, (n, lay.cap)).astype(np.int32)
    vers = rng.integers(-(1 << 31), 1 << 31, (n, lay.cap)).astype(np.int32)
    vals[lay.key_at < 0] = 0
    vers[lay.key_at < 0] = 0
    vers[0, 0] = (1 << 31) - 1            # the version bump wraps
    rec = [rng.integers(-3, 9, shape).astype(np.int32)
           for shape in ((n, t_dim, o), (n, t_dim, o), (n, t_dim),
                         (n, t_dim))]
    t = int(rng.integers(0, 99))
    want = _reference_round_core(keys, write, wval, cur, issue, active,
                                 vals, vers, lay.key_at, *rec, t, k)
    tt = [torch.from_numpy(x) for x in (keys, cur, issue, active)]
    best, att = kernels.txn_claim(*tt, t=t, n_keys=k)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    assert int(att[0]) == int(want[8])
    slots = PKV.key_slots(lay)
    inplace = [torch.from_numpy(x.copy()) for x in (cur, issue)] \
        + [torch.from_numpy(x.copy()) for x in rec]
    req = kernels.txn_commit(
        best, tt[0], torch.from_numpy(write), torch.from_numpy(wval),
        inplace[0], inplace[1], tt[3], slots.owner, slots.slot,
        torch.from_numpy(vals), torch.from_numpy(vers), *inplace[2:], t=t)
    np.testing.assert_array_equal(req.numpy(), np.asarray(want[1]))
    for got, w in zip(inplace, want[2:8]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


# -- the reference's runs and the driver parity --------------------------


def test_clean_run_commits_all_and_serializes():
    # tests/test_txn.py:51-80 on the port, equal to the reference a round
    n, t_dim = 8, 4
    jsim, psim = _sims(n, 8, txns_per_node=t_dim, rate=0.5, until=12,
                       workload_seed=11)
    js, ps = jsim.init_state(), psim.init_state()
    for _ in range(40):
        js, ps = jsim.step(js), psim.step(ps)
        _same(js, ps)
        if bool((ps.cur >= ps.arrived).all()) and ps.t >= 12:
            break
    hist = PT.history_of(ps, psim.ops)
    final = PT.final_registers(ps, psim.layout)
    assert hist == JT.history_of(js, jsim.ops)
    ok, det = PC.check_txn_serializable(hist, final=final)
    assert (ok, det) == JC.check_txn_serializable(hist, final=final)
    assert ok, det["problems"]
    assert det["by_kind"] == {}
    committed = [h for h in hist if h["status"] == "committed"]
    assert det["n_committed"] == len(committed) == len(hist)
    for h in committed:
        assert 0 <= h["issue_round"] <= h["commit_round"]
    for key, (val, ver) in final.items():
        installs = [op for h in committed for op in h["ops"]
                    if op["kind"] == "w" and op["key"] == key]
        if installs:
            top = max(op["ver"] for op in installs)
            assert ver == top
            assert val in [op["val"] for op in installs
                           if op["ver"] == top]


def test_step_run_and_run_fused_all_bit_exact():
    # tests/test_txn.py:83-100 off-mesh: step, run and run_fused agree
    # with each other and with the reference; run leaves its input as it
    # was, run_fused updates it in place
    n = 16
    spec = dict(n_nodes=n, seed=7, crash=((2, 4, (3,)),), loss_rate=0.2,
                loss_until=5)
    jsim, psim = _sims(n, 8, spec, txns_per_node=4, ops_per_txn=2,
                       rate=0.5, until=10, workload_seed=3)
    js, ps = _drive(jsim, psim, 14)
    s0 = psim.init_state()
    _same(js, psim.run(s0, 14))
    assert bool((s0.commit_round == -1).all()) and s0.t == 0
    s1 = psim.init_state()
    out = psim.run_fused(s1, 14)
    _same(js, out)
    assert out.cur is s1.cur and out.op_ver is s1.op_ver
    _same(jsim.run(jsim.init_state(), 14), out)
    _same(jsim.run_fused(jsim.init_state(), 14), out)


def test_nemesis_certifies_crash_loss_campaign():
    # tests/test_txn.py:103-117, the port's result equal to the
    # reference's field for field
    kw = dict(n_nodes=8, seed=3, crash=((3, 6, (4,)),), loss_rate=0.2,
              loss_until=6)
    res = PH.run_txn_nemesis(PF.NemesisSpec(**kw), n_keys=8, until=12,
                             max_recovery_rounds=48, device="cpu")
    assert_same_result(JH.run_txn_nemesis(JF.NemesisSpec(**kw), n_keys=8,
                                          until=12, max_recovery_rounds=48),
                       res)
    assert res["ok"] and res["serializable"]
    assert res["serializability"]["by_kind"] == {}
    assert res["n_lost_writes"] == 0
    assert res["converged_round"] is not None
    assert res["provenance"]["check"]["ok"]
    arr = res["provenance"]["arrays"]
    assert np.asarray(arr["issue_round"]).shape == (8, 4)
    assert np.asarray(arr["commit_round"]).shape == (8, 4)


def test_kv_amnesia_fails_loudly_with_named_lost_updates(tmp_path):
    # tests/test_txn.py:120-152: the owner of key 0 crashes under
    # kv_amnesia; the port fails as the reference does, names the lost
    # updates, and its bundle replays in both packages
    n, n_keys = 8, 8
    own = int(PKV.host_owner_of(np.arange(n_keys, dtype=np.int32), n,
                                0)[0])
    kw = dict(n_nodes=n, seed=3, crash=((3, 6, (own,)),))
    out = tmp_path / "port"
    res = PH.run_txn_nemesis(PF.NemesisSpec(**kw), n_keys=n_keys, until=12,
                             max_recovery_rounds=48, kv_amnesia=True,
                             observe_dir=str(out), device="cpu")
    ref = JH.run_txn_nemesis(JF.NemesisSpec(**kw), n_keys=n_keys, until=12,
                             max_recovery_rounds=48, kv_amnesia=True,
                             observe_dir=str(tmp_path / "ref"))
    bundle = res.pop("flight_bundle")
    ref_bundle = ref.pop("flight_bundle")
    assert_same_result(ref, res)
    assert not res["ok"] and not res["serializable"]
    lost = [p for p in res["serializability"]["problems"]
            if p["kind"] in ("lost-update", "lost-acked-commit")]
    assert lost
    for p in lost:
        assert p["txns"], p
    durable = PH.run_txn_nemesis(PF.NemesisSpec(**kw), n_keys=n_keys,
                                 until=12, max_recovery_rounds=48,
                                 device="cpu")
    assert durable["ok"] and durable["serializable"]
    assert os.path.exists(bundle)
    assert PO.load_bundle(bundle)["runner_kw"] \
        == JO.load_bundle(ref_bundle)["runner_kw"]
    for replay in (PO.replay_bundle(bundle, device="cpu"),
                   PO.replay_bundle(ref_bundle, device="cpu"),
                   JO.replay_bundle(bundle)):
        assert not replay["ok"]
        assert replay["serializability"]["by_kind"] \
            == res["serializability"]["by_kind"]
        assert replay["first_divergence_round"] is None


def test_nemesis_rejects_telemetry_series():
    spec = PF.NemesisSpec(n_nodes=4, seed=0)
    with pytest.raises(ValueError, match="stamps"):
        PH.run_txn_nemesis(spec, telemetry=True, device="cpu")


def test_dup_streams_refused_by_both():
    kw = dict(n_nodes=8, seed=0, dup_rate=0.2, dup_until=4)
    jplan = JF.NemesisSpec(**kw).compile()
    for build in (lambda: JT.TxnSim(8, 8, fault_plan=jplan),
                  lambda: PT.TxnSim(8, 8, fault_plan=_port_plan(jplan),
                                    device="cpu")):
        with pytest.raises(ValueError, match="dup"):
            build()
    with pytest.raises(ValueError, match="dup"):
        PH.run_txn_nemesis(PF.NemesisSpec(**kw), device="cpu")


def test_sim_refusals_match_reference():
    from gossip_glomers_tpu.tpu_sim import traffic as JTR
    from gossip_glomers_tpu_torch.tpu_sim import traffic as PTR

    plan = JF.NemesisSpec(n_nodes=6, seed=0).compile()
    cases = [
        (dict(fault_plan=plan), dict(fault_plan=_port_plan(plan)),
         "FaultPlan is for 6"),
        (dict(tspec=JTR.TrafficSpec(n_nodes=8, n_clients=16,
                                    ops_per_client=4, until=4)),
         dict(tspec=PTR.TrafficSpec(n_nodes=8, n_clients=16,
                                    ops_per_client=4, until=4)),
         "ONE client"),
        (dict(tspec=JTR.TrafficSpec(n_nodes=8, n_clients=8,
                                    ops_per_client=3, until=4)),
         dict(tspec=PTR.TrafficSpec(n_nodes=8, n_clients=8,
                                    ops_per_client=3, until=4)),
         "txns_per_node"),
    ]
    for jkw, pkw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            JT.TxnSim(8, 8, **jkw)
        with pytest.raises(ValueError, match=msg):
            PT.TxnSim(8, 8, device="cpu", **pkw)
    # the default arrival spec is the reference's
    jsim, psim = _sims(8, 8, txns_per_node=3, rate=0.4, workload_seed=5)
    assert psim.tspec.to_meta() == jsim.tspec.to_meta()


def test_unported_txn_parts_raise_with_their_items():
    sim = PT.TxnSim(4, 4, device="cpu")
    for fn, item in (
            (lambda: PT.TxnSim(4, 4, device="cpu", mesh=object()), 10),
            (lambda: PT.TxnSim(4, 4, device="cpu", dcn_mode="sync"), 10),
            (PT.ops_specs, 10), (lambda: sim._state_spec, 10),
            (lambda: sim.audit_run_program, 14),
            (PT.audit_contracts, 14),
            (lambda: PH.run_txn_frontier([0.5], [], mesh=object(),
                                         device="cpu"), 10),
            (lambda: PH.run_txn_nemesis(PF.NemesisSpec(n_nodes=4),
                                        mesh=object(), device="cpu"), 10)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()
    with pytest.raises(AttributeError):
        sim.no_such_method
    # the scenario batches' hooks run
    st = PT._build_batch_round(sim)(sim.init_state())
    assert st.t == 1 and PT._batch_converged(st).dtype == torch.bool


def test_txn_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.TxnSim(4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PH.run_txn_nemesis(PF.NemesisSpec(n_nodes=4))


# -- the seeded random probe ------------------------------------------------


def _probe_case(seed: int) -> dict:
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 34))
    k = int(rng.integers(1, 41))
    t_dim = int(rng.integers(1, 7))
    o = int(rng.integers(1, min(k, 4) + 1))
    spec = None
    if rng.random() < 0.8:
        crash = []
        for _ in range(int(rng.integers(0, 3))):
            s = int(rng.integers(0, 10))
            nodes = tuple(sorted({int(x) for x in
                                  rng.integers(0, n, rng.integers(1, 4))}))
            crash.append((s, s + int(rng.integers(1, 6)), nodes))
        loss = float(rng.choice([0.0, 0.1, 0.3]))
        spec = dict(n_nodes=n, seed=int(rng.integers(0, 1 << 16)),
                    crash=tuple(crash), loss_rate=loss,
                    loss_until=int(rng.integers(1, 14)) if loss else None)
    return dict(n=n, k=k, spec=spec,
                kw=dict(txns_per_node=t_dim, ops_per_txn=o,
                        rate=float(np.round(rng.uniform(0.1, 1.0), 3)),
                        until=int(rng.integers(1, 16)),
                        workload_seed=int(rng.integers(0, 99)),
                        seed=int(rng.integers(0, 9)),
                        kv_amnesia=bool(rng.random() < 0.5)),
                rounds=int(rng.integers(6, 22)),
                mid=int(rng.integers(1, 6)) if rng.random() < 0.4 else 0)


@pytest.mark.parametrize("seed", range(24))
def test_random_probe_equals_reference_every_round(seed):
    case = _probe_case(seed)
    jsim, psim = _sims(case["n"], case["k"], case["spec"], **case["kw"])
    js = ps = None
    if case["mid"]:
        # carry the reference's mid-run state across into the port
        js = jsim.init_state()
        for _ in range(case["mid"]):
            js = jsim.step(js)
        ps = PT.state_from_numpy(js, "cpu")
        _same(js, ps, "carried")
    js, ps = _drive(jsim, psim, case["rounds"], js, ps)
    hist = PT.history_of(ps, psim.ops)
    final = PT.final_registers(ps, psim.layout)
    assert PC.check_txn_serializable(hist, final=final) \
        == JC.check_txn_serializable(hist, final=final)


# -- the checker's falsifiability (tests/test_txn.py:238-332) -------------


def _txn(tid, ops, *, status="committed", commit=1, issue=0):
    return {"id": tid, "node": 0, "slot": tid, "status": status,
            "issue_round": issue, "commit_round": commit,
            "ops": [{"kind": k, "key": key, "ver": ver, "val": val}
                    for k, key, ver, val in ops]}


# (history, final, the anomaly it must name or None, what that names)
PLANTED = {
    "clean": ([_txn(1, [("w", 0, 1, 5)], commit=1),
               _txn(2, [("r", 0, 1, 5), ("w", 1, 1, 6)], commit=2)],
              {0: (5, 1), 1: (6, 1)}, None, {}),
    "lost_update": ([_txn(1, [("w", 0, 1, 5)], commit=1),
                     _txn(7, [("w", 0, 1, 9)], commit=3)], None,
                    "lost-update", {"txns": [1, 7], "key": 0, "ver": 1}),
    "g1a_aborted_read": ([_txn(3, [("w", 0, 1, 42)], status="open",
                               commit=-1),
                          _txn(8, [("r", 0, 1, 42)], commit=2)], None,
                         "G1a-aborted-read", {"txns": [3, 8], "val": 42}),
    "g1b_intermediate_read": ([_txn(1, [("w", 0, 1, 7)], commit=1),
                               _txn(2, [("r", 0, 1, 8)], commit=2)], None,
                              "G1b-intermediate-read",
                              {"txns": [1, 2], "saw": 8,
                               "committed": [7]}),
    "write_skew_cycle": ([_txn(1, [("r", 0, 0, 0), ("w", 1, 1, 5)],
                               commit=2),
                          _txn(2, [("r", 1, 0, 0), ("w", 0, 1, 6)],
                               commit=2)], None, "write-cycle",
                         {"txns": [1, 2]}),
    "round_order_violation": ([_txn(1, [("w", 0, 1, 3)], commit=5),
                               _txn(2, [("r", 0, 1, 3)], commit=2)], None,
                              "round-order-violation",
                              {"txns": [1, 2], "rounds": (5, 2)}),
    "lost_acked_commit": ([_txn(4, [("w", 0, 1, 9)], commit=1)],
                          {0: (0, 0)}, "lost-acked-commit",
                          {"txns": [4], "final_ver": 0,
                           "max_committed_ver": 1}),
    "dangling_version_read": ([_txn(6, [("r", 0, 3, 77)], commit=1)], None,
                              "dangling-version-read", {"txns": [6]}),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_checker_flags_each_planted_anomaly(name):
    hist, final, kind, names = PLANTED[name]
    ok, det = PC.check_txn_serializable(hist, final=final)
    assert (ok, det) == JC.check_txn_serializable(hist, final=final)
    if kind is None:
        assert ok and det["n_edges"] >= 1, det["problems"]
        return
    assert not ok
    [p] = [p for p in det["problems"] if p["kind"] == kind]
    for key, want in names.items():
        assert (tuple(p[key]) if key == "rounds" else p[key]) == want
    if kind == "write-cycle":
        assert set(p["cycle"]) == {1, 2}


def _mutate(hist: list, rng) -> list:
    """A copy of ``hist`` with a few seeded faults planted: a read's value
    or version changed, a write's version reused, a commit round moved, a
    transaction's status flipped."""
    hist = copy.deepcopy(hist)
    for _ in range(int(rng.integers(1, 4))):
        h = hist[int(rng.integers(0, len(hist)))]
        what = int(rng.integers(0, 4))
        if what == 0 and h["ops"]:
            op = h["ops"][int(rng.integers(0, len(h["ops"])))]
            op["val"] += int(rng.integers(1, 3))
        elif what == 1 and h["ops"]:
            op = h["ops"][int(rng.integers(0, len(h["ops"])))]
            op["ver"] = max(0, op["ver"] - int(rng.integers(1, 3)))
        elif what == 2:
            h["commit_round"] = int(rng.integers(0, 30))
        else:
            h["status"] = "open" if h["status"] == "committed" \
                else "committed"
    return hist


@pytest.mark.parametrize("seed", range(6))
def test_checker_verdicts_equal_reference_on_random_and_mutated(seed):
    # a seeded campaign's history, then mutated copies: the port's copy
    # returns the reference's verdict and details, problems and edge
    # count included
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 20))
    spec = PF.NemesisSpec(n_nodes=n, seed=seed, crash=((2, 5, (1, 3)),),
                          loss_rate=0.2, loss_until=6)
    psim = PT.TxnSim(n, int(rng.integers(3, 12)), txns_per_node=4,
                     rate=0.6, until=10, fault_plan=spec.compile("cpu"),
                     kv_amnesia=bool(seed % 2), workload_seed=seed,
                     device="cpu")
    st = psim.run(psim.init_state(), 24)
    hist = PT.history_of(st, psim.ops)
    final = PT.final_registers(st, psim.layout)
    for trial in range(8):
        h = hist if trial == 0 else _mutate(hist, rng)
        f = final if trial % 2 == 0 else None
        assert PC.check_txn_serializable(h, final=f) \
            == JC.check_txn_serializable(h, final=f)


@pytest.mark.parametrize("max_problems", (0, 1, 5, 10, 64))
def test_checker_counts_unlisted_cycles_as_reference(max_problems):
    # 24 write-skew pairs (24 cycles) and lost updates: the port lists the
    # same first problems and counts the same kinds, cycles past the list
    # included
    hist = []
    for p in range(24):
        a, b = 2 * p + 1, 2 * p + 2
        ka, kb = 2 * p, 2 * p + 1
        hist += [_txn(a, [("r", ka, 0, 0), ("w", kb, 1, 5)], commit=2),
                 _txn(b, [("r", kb, 0, 0), ("w", ka, 1, 6)], commit=2)]
    hist += [_txn(100, [("w", 0, 1, 9)], commit=3)]
    for final in (None, {0: (0, 0)}):
        got = PC.check_txn_serializable(hist, final=final,
                                        max_problems=max_problems)
        assert got == JC.check_txn_serializable(hist, final=final,
                                                max_problems=max_problems)
        assert got[1]["by_kind"]["write-cycle"] == 24
