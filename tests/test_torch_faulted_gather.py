"""Port parity for the faulted node-major gather round: ``_live_split``,
the plain versions of the fault kernels (``fault_coins``,
``faulted_gather_round``), ``flood_step(plan=...)`` round by round, the
gather-path ``BroadcastSim(fault_plan=...)`` and the streamed
``union_block`` rounds of gossip_glomers_tpu_torch against the JAX
reference on the CPU.

Adjacency, specs and bitsets come from seeded numpy and go to both
packages; bitsets, round counts, coins and the ``msgs`` / ``srv_msgs``
ledgers compare exactly (tolerance 0).  The JAX sims are built with
``mesh=None`` (conftest forces an 8-device virtual CPU mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import engine as jengine
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim.structured import make_exchange as jex
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import engine as pengine
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst

# crash + loss + dup (srv ledger off) and crash + loss (srv ledger on)
NEMESES = {
    "crash_loss_dup": lambda n: dict(
        n_nodes=n, seed=5, crash=((2, 7, tuple(range(0, n, 5))),),
        loss_rate=0.2, loss_until=9, dup_rate=0.15, dup_until=9),
    "crash_loss": lambda n: dict(
        n_nodes=n, seed=6, crash=((1, 4, (0, 3)), (3, 8, (2, 7, 11))),
        loss_rate=0.25, loss_until=10),
}


def _nbrs(topology: str, n: int) -> np.ndarray:
    if topology == "grid":
        return jtop.to_padded_neighbors(jtop.grid(n))
    if topology == "tree":
        return jtop.to_padded_neighbors(jtop.tree(n))
    return jtop.random_regular(n, 4, seed=1)


def _parts(n: int, windows, seed: int = 3):
    """(JAX Partitions, port Partitions) of one schedule."""
    group = np.random.default_rng(seed).integers(0, 2, (len(windows), n))
    starts = np.array([a for a, _ in windows], np.int32)
    ends = np.array([b for _, b in windows], np.int32)
    return (jbc.Partitions(jnp.asarray(starts), jnp.asarray(ends),
                           jnp.asarray(group.astype(np.int8))),
            pbc.Partitions.from_numpy(starts, ends, group))


def _plans(kw):
    """(JAX plan, port plan) of one spec: the port's built from the
    reference plan's leaves."""
    jplan = jf.NemesisSpec(**kw).compile()
    return jplan, pf.plan_from_numpy(
        **{k: np.asarray(v) for k, v in jplan._asdict().items()})


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("dup_on", (False, True))
@pytest.mark.parametrize("windows", ([], [(2, 6)]))
def test_live_split_matches_reference(windows, dup_on):
    n = 40
    nbrs = _nbrs("tree", n)            # ragged: pad edges stay dead
    jp, pp = _parts(n, windows)
    jplan, pplan = _plans(NEMESES["crash_loss_dup"](n))
    rows = np.arange(n, dtype=np.int32)
    nt = torch.from_numpy(nbrs)
    for t in range(0, 11):
        want = jbc._live_split(jnp.int32(t), jnp.asarray(rows),
                               jnp.asarray(nbrs), jnp.asarray(nbrs >= 0), jp,
                               jplan, dup_on)
        got = pbc._live_split(t, torch.from_numpy(rows).long(), nt, nt >= 0,
                              pp, pplan, dup_on)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"t={t}")
    # no plan: the partition mask three times over
    live = pbc._live_split(3, torch.arange(n), nt, nt >= 0, pp, None, True)
    assert live[0] is live[1] and live[2] is None


@pytest.mark.parametrize("windows", ([], [(1, 5)]))
@pytest.mark.parametrize("t", (0, 3, 8, 9))
def test_fault_coins_plain_is_the_reference_composition(t, windows):
    # the flag bytes are _live_split's three masks and the srv ledger's
    # out_ok coin, bit for bit
    n = 40
    nbrs = _nbrs("random_regular", n)
    nbrs[np.random.default_rng(0).random(nbrs.shape) < 0.1] = -1
    jp, pp = _parts(n, windows)
    jplan, pplan = _plans(NEMESES["crash_loss_dup"](n))
    rows = jnp.arange(n, dtype=jnp.int32)
    send, deliver, dup = (np.asarray(m) for m in jbc._live_split(
        jnp.int32(t), rows, jnp.asarray(nbrs), jnp.asarray(nbrs >= 0), jp,
        jplan, True))
    out_ok = ~np.asarray(jf.edge_drop(jplan, jnp.int32(t), rows[:, None],
                                      jnp.clip(jnp.asarray(nbrs), 0, n - 1)))
    nt = torch.from_numpy(nbrs)
    live = pbc._edge_live(t, torch.arange(n), nt, nt >= 0, pp)
    coins = pbc._coins(pplan, t, True, out_ok=True)
    up = pf.node_up(pplan, t, torch.arange(n))
    flags = kernels.fault_coins(nt, up, live=live, **coins).numpy()
    for bit, want in ((kernels.FLAG_SEND, send), (kernels.FLAG_DEL, deliver),
                      (kernels.FLAG_DUP, dup),
                      (kernels.FLAG_OUT_OK, out_ok)):
        np.testing.assert_array_equal((flags & bit) != 0, want)
    # a slab of rows [lo, hi) is those rows of the whole table
    lo, hi = 13, 29
    slab = kernels.fault_coins(nt[lo:hi], up, live=live[lo:hi], row0=lo,
                               **coins)
    np.testing.assert_array_equal(slab.numpy(), flags[lo:hi])


@pytest.mark.parametrize("dup", (False, True))
@pytest.mark.parametrize("w", (1, 3))
def test_faulted_gather_round_plain_is_the_reference_composition(w, dup):
    # new = (gather_or(payload, DEL) | gather_or(received, DUP)) & ~rec and
    # the dup charge sum_DUP popc(received[src]), against the reference's
    # _gather_or and its ledger term
    n, n_src, d = 37, 45, 5
    rng = np.random.default_rng(w + 2 * dup)
    nbrs = rng.integers(-1, n_src + 3, (n, d)).astype(np.int32)
    flags = rng.integers(0, 16, (n, d)).astype(np.uint8)
    u32 = lambda shape: rng.integers(0, 1 << 32, shape,  # noqa: E731
                                     dtype=np.uint64).astype(np.uint32)
    payload, received, rec = u32((n_src, w)), u32((n_src, w)), u32((n, w))
    deliver, dups = (flags & 2) != 0, (flags & 4) != 0
    inbox = np.asarray(jbc._gather_or(jnp.asarray(payload),
                                      jnp.asarray(nbrs),
                                      jnp.asarray(deliver)))
    want_pc = 0
    if dup:
        inbox = inbox | np.asarray(jbc._gather_or(
            jnp.asarray(received), jnp.asarray(nbrs), jnp.asarray(dups)))
        pc_src = np.unpackbits(received.view(np.uint8), axis=1).sum(1)
        want_pc = int(np.where(dups, pc_src[np.clip(nbrs, 0, n_src - 1)],
                               0).sum()) % (1 << 32)
    t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    new, rec_next, pc = kernels.faulted_gather_round(
        t(payload), t(received) if dup else None, t(rec),
        torch.from_numpy(nbrs), torch.from_numpy(flags))
    np.testing.assert_array_equal(_bits(new), inbox & ~rec)
    np.testing.assert_array_equal(_bits(rec_next), rec | (inbox & ~rec))
    assert int(pc) == want_pc


def _state_pair(inject, srv, msgs0=(1 << 32) - 900, srv0=(1 << 32) - 50):
    js = jbc.BroadcastState(received=jnp.asarray(inject),
                            frontier=jnp.asarray(inject), t=jnp.int32(0),
                            msgs=jnp.uint32(msgs0),
                            srv_msgs=jnp.uint32(srv0) if srv else None)
    ps = pbc.state_from_numpy(inject, inject, 0, msgs0,
                              srv0 if srv else None, "cpu",
                              words_major=False)
    return js, ps


def _assert_state(ps, js):
    np.testing.assert_array_equal(_bits(ps.received), np.asarray(js.received))
    np.testing.assert_array_equal(_bits(ps.frontier), np.asarray(js.frontier))
    assert ps.t == int(js.t)
    assert int(ps.msgs) == int(js.msgs)
    assert (ps.srv_msgs is None) == (js.srv_msgs is None)
    if js.srv_msgs is not None:
        assert int(ps.srv_msgs) == int(js.srv_msgs)


@pytest.mark.parametrize("windows", ([], [(2, 6)]))
@pytest.mark.parametrize("nemesis,srv", (("crash_loss_dup", False),
                                         ("crash_loss", True)))
@pytest.mark.parametrize("topology,n", (("grid", 16), ("tree", 40),
                                        ("random_regular", 40)))
def test_flood_step_with_plan_matches_reference(topology, n, nemesis, srv,
                                                windows):
    nbrs = _nbrs(topology, n)
    jp, pp = _parts(n, windows)
    kw = NEMESES[nemesis](n)
    jplan, pplan = _plans(kw)
    dup_on = "dup_rate" in kw
    js, ps = _state_pair(jbc.make_inject(n, 45), srv)
    nt = torch.from_numpy(nbrs)
    step = jax.jit(lambda s: jbc.flood_step(
        s, nbrs=jnp.asarray(nbrs), nbr_mask=jnp.asarray(nbrs >= 0),
        parts=jp, sync_every=3, plan=jplan, dup_on=dup_on))
    for _ in range(14):              # past every fault; sync every 3
        js = step(js)
        ps = pbc.flood_step(ps, nbrs=nt, nbr_mask=nt >= 0, parts=pp,
                            sync_every=3, plan=pplan, dup_on=dup_on)
        _assert_state(ps, js)


def _sims(nbrs, kw, **sim_kw):
    jplan, pplan = _plans(kw)
    jparts = sim_kw.pop("jparts", None)
    pparts = sim_kw.pop("pparts", None)
    jsim = jbc.BroadcastSim(nbrs, fault_plan=jplan, parts=jparts, mesh=None,
                            **sim_kw)
    psim = pbc.BroadcastSim(nbrs, fault_plan=pplan, parts=pparts,
                            device="cpu", **sim_kw)
    return jsim, psim


def _assert_runs(jsim, jstate, jrounds, psim, pstate, prounds):
    assert prounds == jrounds
    np.testing.assert_array_equal(psim.received_node_major(pstate),
                                  np.asarray(jsim.received_node_major(jstate)))
    assert pstate.t == int(jstate.t)
    assert int(pstate.msgs) == int(jstate.msgs)
    assert (pstate.srv_msgs is None) == (jstate.srv_msgs is None)
    if jstate.srv_msgs is not None:
        assert psim.server_msgs(pstate) == jsim.server_msgs(jstate)


@pytest.mark.parametrize("windows", (False, True))
@pytest.mark.parametrize("nemesis,srv", (("crash_loss_dup", False),
                                         ("crash_loss", True)))
def test_gather_sim_with_plan_matches_reference(nemesis, srv, windows):
    n, nv = 40, 50
    nbrs = _nbrs("random_regular", n)
    jp, pp = _parts(n, [(2, 8)] if windows else [])
    jsim, psim = _sims(nbrs, NEMESES[nemesis](n), n_values=nv, sync_every=4,
                       srv_ledger=srv, jparts=jp, pparts=pp)
    assert psim._fp_dup == jsim._fp_dup and psim._ub is None
    inject = jbc.make_inject(n, nv)
    jref, jrounds = jsim.run_fused(inject)
    _assert_runs(jsim, jref, jrounds, psim, *psim.run_fused(inject))
    _assert_runs(jsim, jref, jrounds, psim, *psim.run(inject))
    ps0, target = psim.stage(inject)
    pfix = psim.run_staged_fixed(ps0, jrounds)
    _assert_runs(jsim, jref, jrounds, psim, pfix, pfix.t)
    assert psim.converged(pfix, target)


def test_dup_delivery_is_absorbed_but_ledger_visible():
    # tests/test_nemesis.py's case: the same seed with and without the dup
    # stream gives the same received sets and strictly more messages, in
    # both packages alike
    n, nv = 16, 24
    nbrs = jtop.to_padded_neighbors(jtop.grid(n))
    base = dict(n_nodes=n, seed=7, crash=((3, 8, (2, 5)),), loss_rate=0.0)
    inject = jbc.make_inject(n, nv)
    out = {}
    for name, kw in (("no_dup", base),
                     ("dup", {**base, "dup_rate": 0.3, "dup_until": 10})):
        jsim, psim = _sims(nbrs, kw, n_values=nv, sync_every=4,
                           srv_ledger=False)
        jstate, jrounds = jsim.run(inject)
        pstate, prounds = psim.run(inject)
        _assert_runs(jsim, jstate, jrounds, psim, pstate, prounds)
        out[name] = (psim.received_node_major(pstate), int(pstate.msgs))
    np.testing.assert_array_equal(out["no_dup"][0], out["dup"][0])
    assert out["dup"][1] > out["no_dup"][1]


@pytest.mark.parametrize("srv", (False, True))
def test_join_leave_plan_matches_reference(srv):
    # joiners enter empty and learn by anti-entropy; the leaver is never
    # up again, so the run stops at max_rounds in both packages
    n, nv = 24, 30
    nbrs = _nbrs("random_regular", n)
    kw = dict(n_nodes=n, seed=4, crash=((2, 4, (1,)),), loss_rate=0.1,
              loss_until=6, join=((3, (5, 6)),), leave=((4, (9,)),))
    jsim, psim = _sims(nbrs, kw, n_values=nv, sync_every=3, srv_ledger=srv)
    inject = jbc.make_inject(n, nv)
    jref, jrounds = jsim.run_fused(inject, max_rounds=20)
    _assert_runs(jsim, jref, jrounds, psim,
                 *psim.run_fused(inject, max_rounds=20))
    js, ps = jsim.init_state(inject), psim.init_state(inject)
    for _ in range(9):
        js, ps = jsim.step(js), psim.step(ps)
        _assert_state(ps, js)


def _full_mesh(n):
    return np.stack([[j for j in range(n) if j != i]
                     for i in range(n)]).astype(np.int32)


@pytest.mark.parametrize("topo", ("full_mesh", "star"))
def test_blocked_gather_matches_materialized_and_reference(topo):
    # tests/test_nemesis.py's O(N^2) shapes under crash + loss + dup and a
    # partition window: blocked (8-row slabs) = materialized = JAX
    n, nv = 24, 20
    nbrs = (_full_mesh(n) if topo == "full_mesh"
            else jtop.to_padded_neighbors(jtop.tree(n, branching=n - 1)))
    kw = dict(n_nodes=n, seed=3, crash=((2, 6, (1, 5)),), loss_rate=0.2,
              loss_until=8, dup_rate=0.1, dup_until=8)
    jp, pp = _parts(n, [(3, 6)])
    sim_kw = dict(n_values=nv, sync_every=4, srv_ledger=False)
    jsim, mat = _sims(nbrs, kw, union_block="materialized", jparts=jp,
                      pparts=pp, **sim_kw)
    _, blk = _sims(nbrs, kw, union_block=8, jparts=jp, pparts=pp, **sim_kw)
    assert blk._ub == 8 and mat._ub is None
    inject = jbc.make_inject(n, nv)
    jref, jrounds = jsim.run(inject, max_rounds=100)
    for psim in (mat, blk):
        _assert_runs(jsim, jref, jrounds, psim,
                     *psim.run(inject, max_rounds=100))
        _assert_runs(jsim, jref, jrounds, psim,
                     *psim.run_fused(inject, max_rounds=100))
    # one round at a time, flood_step blocked against materialized
    jplan, pplan = _plans(kw)
    nt = torch.from_numpy(nbrs)
    a = b = blk.init_state(inject)
    for _ in range(8):
        a = pbc.flood_step(a, nbrs=nt, nbr_mask=nt >= 0, parts=pp,
                           sync_every=4, plan=pplan, dup_on=True)
        b = pbc.flood_step(b, nbrs=nt, nbr_mask=nt >= 0, parts=pp,
                           sync_every=4, plan=pplan, dup_on=True,
                           union_block=6)
        assert torch.equal(a.received, b.received)
        assert torch.equal(a.frontier, b.frontier)
        assert int(a.msgs) == int(b.msgs)


def test_blocked_gather_guards():
    # tests/test_nemesis.py's guards: blocked rounds are gather-path-only
    # and keep no srv ledger
    n = 16
    nbrs = jtop.to_padded_neighbors(jtop.grid(n))
    kw = dict(n_nodes=n, seed=0, loss_rate=0.2, loss_until=4)
    jplan, pplan = _plans(kw)
    for mod, ex, plan, dev in ((jbc, jex("grid", n), jplan, {"mesh": None}),
                               (pbc, pst.make_exchange("grid", n), pplan,
                                {"device": "cpu"})):
        with pytest.raises(ValueError, match="gather-free"):
            mod.BroadcastSim(nbrs, n_values=8, union_block=4, exchange=ex,
                             **dev)
        with pytest.raises(ValueError, match="srv") as err:
            mod.BroadcastSim(nbrs, n_values=8, union_block=4,
                             fault_plan=plan, **dev)
        sim = mod.BroadcastSim(nbrs, n_values=8, union_block=4,
                               srv_ledger=False, fault_plan=plan, **dev)
        assert sim._ub == 4
        if mod is jbc:
            want = str(err.value)
        else:
            assert str(err.value) == want
    # the dup stream rejects the srv ledger; a plan for another n rejects
    dup_plan = _plans({**kw, "dup_rate": 0.1, "dup_until": 4})[1]
    with pytest.raises(ValueError, match="dup stream"):
        pbc.BroadcastSim(nbrs, n_values=8, fault_plan=dup_plan, device="cpu")
    with pytest.raises(ValueError, match="FaultPlan is for"):
        pbc.BroadcastSim(nbrs[:8], n_values=8, fault_plan=pplan,
                         device="cpu")
    # an env-chosen block yields to the srv ledger
    assert pbc.BroadcastSim(nbrs, n_values=8, fault_plan=pplan,
                            device="cpu")._ub is None


@pytest.mark.parametrize("env,budget", (
    ("4", None), ("5", None), ("auto", None), ("auto", "0"),
    ("materialized", None), ("nope", None), ("auto", "-1"), ("auto", "x"),
    ("0", None), ("400", None), ("-3", None)))
def test_resolve_block_env_matches_reference(monkeypatch, env, budget):
    monkeypatch.setenv("GG_UNION_BLOCK", env)
    if budget is None:
        monkeypatch.delenv("GG_UNION_BLOCK_BUDGET_MB", raising=False)
    else:
        monkeypatch.setenv("GG_UNION_BLOCK_BUDGET_MB", budget)
    for rows, per_row in ((96, 128), (97, 1 << 24)):
        try:
            want = jengine.resolve_block(rows, per_row_bytes=per_row)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pengine.resolve_block(rows, per_row_bytes=per_row)
            assert str(got.value) == str(e)
        else:
            assert pengine.resolve_block(rows, per_row_bytes=per_row) \
                == want


@pytest.mark.parametrize("setting", ("materialized", "auto", 0, 5, 7, 96,
                                     200, "bogus", 2.5))
def test_resolve_block_settings_match_reference(setting):
    for rows in (96, 97):
        try:
            want = jengine.resolve_block(rows, setting, per_row_bytes=64,
                                         budget_bytes=1000)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pengine.resolve_block(rows, setting, per_row_bytes=64,
                                      budget_bytes=1000)
            assert str(got.value) == str(e)
        else:
            assert pengine.resolve_block(rows, setting, per_row_bytes=64,
                                         budget_bytes=1000) == want


def test_scan_blocks_runs_every_slab_in_order():
    assert pengine.scan_blocks(lambda c, lo: c + [lo], [], 12, 4) \
        == [0, 4, 8]
    with pytest.raises(ValueError, match="divide"):
        pengine.scan_blocks(lambda c, lo: c, None, 12, 5)
