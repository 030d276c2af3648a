"""The slices as a whole: the port's words-major BroadcastSim — the tree
flood and the circulant, ring, line and grid floods — against the JAX
reference's, run on the CPU (the gather path is in test_torch_gather.py).

Both sims take the same ``make_inject`` workload; the JAX sims are built
with ``mesh=None`` explicitly (conftest forces an 8-device virtual CPU
mesh that ``timing.structured_sim`` would otherwise pick up).  Rounds,
received bitsets and the ``msgs`` / ``srv_msgs`` ledgers compare exactly
(tolerance 0).
"""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.parallel.topology import to_padded_neighbors, tree
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu.tpu_sim import timing as jtiming
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import timing as ptiming


def _sims(n, nv, sync_every, srv):
    nbrs = to_padded_neighbors(tree(n))
    jsim = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=sync_every, mesh=None,
        exchange=jst.make_exchange("tree", n, branching=4),
        sync_diff=jst.make_sync_diff("tree", n, branching=4) if srv
        else None, srv_ledger=srv)
    psim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=sync_every,
        exchange=pst.make_exchange("tree", n, branching=4),
        sync_diff=pst.make_sync_diff("tree", n, branching=4) if srv
        else None, srv_ledger=srv, device="cpu")
    return jsim, psim


def _assert_states_equal(jsim, jstate, psim, pstate):
    np.testing.assert_array_equal(psim.received_node_major(pstate),
                                  np.asarray(jsim.received_node_major(
                                      jstate)))
    np.testing.assert_array_equal(
        pstate.frontier.numpy().view(np.uint32),
        np.asarray(jstate.frontier))
    assert pstate.t == int(jstate.t)
    assert int(pstate.msgs) == int(jstate.msgs)
    assert (pstate.srv_msgs is None) == (jstate.srv_msgs is None)
    if jstate.srv_msgs is not None:
        assert psim.server_msgs(pstate) == jsim.server_msgs(jstate)


# (n, n_values, sync_every): W = 1 and W = 3; sync_every = 64 lets no
# sync wave fire, sync_every = 3 fires waves inside the loop
CASES = [(64, 32, 64), (256, 96, 64), (64, 32, 3), (256, 96, 3)]


@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("n,nv,sync_every", CASES)
def test_slice_matches_reference(n, nv, sync_every, srv):
    jsim, psim = _sims(n, nv, sync_every, srv)
    inject = jbc.make_inject(n, nv)

    jref, jrounds = jsim.run_fused(inject)
    pref, prounds = psim.run_fused(inject)
    assert prounds == jrounds
    _assert_states_equal(jsim, jref, psim, pref)
    if sync_every < jrounds:
        assert (psim.build_fixed(jrounds) is None)      # waves fire

    # the fixed-trip runner equals the while runner on both sides, and
    # the pure-flood specialization engages in the same cases
    assert (psim.build_fixed(jrounds) is None) \
        == (jsim.build_fixed(jrounds) is None)
    js0, _ = jsim.stage(inject)
    ps0, _ = psim.stage(inject)
    jfix = jsim.run_staged_fixed(js0, jrounds)
    pfix = psim.run_staged_fixed(ps0, jrounds)
    _assert_states_equal(jsim, jfix, psim, pref)
    _assert_states_equal(jsim, jfix, psim, pfix)
    # not donated: the staged state is left as it was
    np.testing.assert_array_equal(ps0.received.numpy().view(np.uint32),
                                  inject.T)

    # the host-stepped runner agrees too
    prun, prun_rounds = psim.run(inject)
    assert prun_rounds == jrounds
    _assert_states_equal(jsim, jref, psim, prun)

    # one step from a mid-run reference state carried across
    mid = jsim.init_state(inject)
    for _ in range(2):
        mid = jsim.step(mid)
    carried = pbc.state_from_numpy(
        np.asarray(mid.received).T, np.asarray(mid.frontier).T, int(mid.t),
        int(mid.msgs), None if mid.srv_msgs is None else int(mid.srv_msgs),
        device="cpu")
    _assert_states_equal(jsim, mid, psim, carried)
    _assert_states_equal(jsim, jsim.step(mid), psim, psim.step(carried))


def test_sync_wave_round_matches_reference():
    # a step AT a sync round (t % sync_every == 0, t > 0): the payload is
    # the full received set and the srv ledger adds the pairwise diff
    jsim, psim = _sims(64, 32, 2, True)
    inject = jbc.make_inject(64, 32)
    js = jsim.init_state(inject)
    ps = psim.init_state(inject)
    for _ in range(5):
        js, ps = jsim.step(js), psim.step(ps)
        _assert_states_equal(jsim, js, psim, ps)


def test_flood_specialization_gate_matches_reference():
    for sync_every, srv, rounds in [(64, False, 5), (4, False, 5),
                                    (64, True, 5), (5, False, 5),
                                    (64, False, 0)]:
        jsim, psim = _sims(64, 32, sync_every, srv)
        assert (psim.build_fixed(rounds) is None) \
            == (jsim.build_fixed(rounds) is None), (sync_every, srv, rounds)


def test_state_round_trip():
    rng = np.random.default_rng(5)
    rec = rng.integers(0, 1 << 32, (37, 3), dtype=np.uint64).astype(np.uint32)
    fr = rec & rng.integers(0, 1 << 32, rec.shape,
                            dtype=np.uint64).astype(np.uint32)
    for srv in (None, (1 << 32) - 7):
        state = pbc.state_from_numpy(rec, fr, 9, (1 << 32) - 1, srv, "cpu")
        assert state.received.dtype == torch.int32
        assert state.received.shape == (3, 37)
        back = pbc.state_to_numpy(state)
        np.testing.assert_array_equal(back[0], rec)
        np.testing.assert_array_equal(back[1], fr)
        assert back[2:] == (9, (1 << 32) - 1, srv)


def test_wrap32_matches_numpy_uint32():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    want_sum = np.sum(a, dtype=np.uint32)            # wraps past 2^32
    want_dot = np.sum(a * b, dtype=np.uint32)
    ta = torch.from_numpy(a.astype(np.int64))
    tb = torch.from_numpy(b.astype(np.int64))
    assert int(pbc.wrap32(ta.sum())) == int(want_sum)
    assert int(pbc._dot32(ta, tb)) == int(want_dot)
    assert pbc.wrap32((1 << 32) + 5) == 5


def test_closed_form_ledger_unwrapped():
    # W = 128 at a small n: the true send count passes 2^32 only at
    # scale, so hold msgs64 against the ledger and msgs against msgs64
    n, nv = 1024, 4096
    sim = ptiming.structured_sim("tree", n, nv, branching=4, device="cpu")
    inject = pbc.make_inject(n, nv)
    rounds = ptiming.discover_rounds("tree", n, nv, branching=4)
    state0, target = sim.stage(inject)
    final = sim.run_staged_fixed(state0, rounds)
    assert sim.converged(final, target)
    msgs64 = ptiming.flood_msgs64(sim, final)
    assert int(final.msgs) == msgs64 % (1 << 32)
    assert msgs64 == int((sim.deg * (
        kernels.col_popcount(final.received).long()
        - kernels.col_popcount(final.frontier).long())).sum())


def test_timed_run_needs_a_cuda_sim():
    sim = ptiming.structured_sim("tree", 16, 8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ptiming.TimedRun(sim, pbc.make_inject(16, 8), 3)


def _shift_sims(topology, n, nv, sync_every, srv, kw):
    nbrs = jtiming._nbrs_for(topology, n, **kw)
    jsim = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=sync_every, mesh=None,
        exchange=jst.make_exchange(topology, n, **kw),
        sync_diff=jst.make_sync_diff(topology, n, **kw) if srv else None,
        srv_ledger=srv)
    psim = ptiming.structured_sim(topology, n, nv, sync_every=sync_every,
                                  srv_ledger=srv, device="cpu", **kw)
    return jsim, psim


# (topology, n, n_values, kw): a ragged grid (cols 7 over 50 nodes), the
# default square grid, a ring and a line of odd length (W = 2), and the
# degree-8 circulant expander
SHIFT_CASES = [("grid", 50, 40, {"cols": 7}), ("grid", 64, 32, {}),
               ("ring", 37, 40, {}), ("line", 30, 32, {}),
               ("circulant", 200, 40,
                {"strides": jtop.expander_strides(200, 8, seed=0)})]


@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("sync_every", (64, 3))
@pytest.mark.parametrize("topology,n,nv,kw", SHIFT_CASES,
                         ids=[c[0] + str(c[1]) for c in SHIFT_CASES])
def test_shift_topology_sims_match_reference(topology, n, nv, kw,
                                             sync_every, srv):
    jsim, psim = _shift_sims(topology, n, nv, sync_every, srv, kw)
    inject = jbc.make_inject(n, nv)
    jref, jrounds = jsim.run_fused(inject)
    pref, prounds = psim.run_fused(inject)
    assert prounds == jrounds
    assert jrounds == ptiming.discover_rounds(topology, n, nv, **kw)
    _assert_states_equal(jsim, jref, psim, pref)
    assert (psim.build_fixed(jrounds) is None) \
        == (jsim.build_fixed(jrounds) is None)
    ps0, _ = psim.stage(inject)
    pfix = psim.run_staged_fixed(ps0, jrounds)
    _assert_states_equal(jsim, jref, psim, pfix)
    if psim.build_fixed(jrounds) is not None:
        assert int(pfix.msgs) == ptiming.flood_msgs64(psim, pfix) % (1 << 32)


def _sync0_sims(layout, mode, sync_every, n=64, nv=40):
    """(JAX, port) BroadcastSims on the 64-node grid: node-major (the
    gather) or words-major (the grid's shift exchange), plain, under a
    crash + loss plan, or in a delay mode (per-edge delays on the gather,
    per-direction classes on the words-major path)."""
    from gossip_glomers_tpu.tpu_sim import faults as jf
    from gossip_glomers_tpu_torch.tpu_sim import faults as pf

    nbrs = to_padded_neighbors(jtop.grid(n))
    wm = layout == "words_major"
    jkw, pkw = {}, {"device": "cpu"}
    if wm:
        jkw.update(exchange=jst.make_exchange("grid", n),
                   sync_diff=jst.make_sync_diff("grid", n))
        pkw.update(exchange=pst.make_exchange("grid", n),
                   sync_diff=pst.make_sync_diff("grid", n))
    if mode == "plan":
        spec = dict(n_nodes=n, seed=3, crash=((2, 6, (1, 9, 30)),),
                    loss_rate=0.2, loss_until=8)
        jspec, pspec = jf.NemesisSpec(**spec), pf.NemesisSpec(**spec)
        jkw["fault_plan"] = jspec.compile()
        pkw["fault_plan"] = pspec.compile(device="cpu")
        if wm:
            jkw["nemesis"] = jst.make_nemesis("grid", n, jspec)
            pkw["nemesis"] = pst.make_nemesis("grid", n, pspec,
                                              device="cpu")
    elif mode == "delay":
        if wm:
            jkw["delayed"] = jst.make_delayed("grid", n, (1, 3, 2, 1))
            pkw["delayed"] = pst.make_delayed("grid", n, (1, 3, 2, 1))
        else:
            rng = np.random.default_rng(5)
            delays = np.where(nbrs >= 0, rng.integers(1, 4, nbrs.shape),
                              1).astype(np.int32)
            jkw["delays"] = pkw["delays"] = delays
    return (jbc.BroadcastSim(nbrs, n_values=nv, sync_every=sync_every,
                             mesh=None, **jkw),
            pbc.BroadcastSim(nbrs, n_values=nv, sync_every=sync_every,
                             **pkw))


@pytest.mark.parametrize("mode", ("plain", "plan", "delay"))
@pytest.mark.parametrize("layout", ("node_major", "words_major"))
def test_sync_every_zero_matches_reference(layout, mode):
    # the reference's t % 0 is 0, so at sync_every=0 every round after
    # round 0 is a sync wave: the same run as sync_every=1
    n, nv = 64, 40
    inject = jbc.make_inject(n, nv)
    jsim, psim = _sync0_sims(layout, mode, 0)
    jref, jrounds = jsim.run(inject, max_rounds=400)
    pref, prounds = psim.run(inject, max_rounds=400)
    assert prounds == jrounds
    _assert_states_equal(jsim, jref, psim, pref)
    one, one_rounds = _sync0_sims(layout, mode, 1)[1].run(inject,
                                                          max_rounds=400)
    assert one_rounds == prounds and int(one.msgs) == int(pref.msgs)
    assert (one.srv_msgs is None) == (pref.srv_msgs is None)
    if one.srv_msgs is not None:
        assert int(one.srv_msgs) == int(pref.srv_msgs)
    if mode == "plain":
        assert (prounds, int(pref.msgs)) == (14, 80_720)
    # step by step, round for round
    js, ps = jsim.init_state(inject), psim.init_state(inject)
    for _ in range(4):
        js, ps = jsim.step(js), psim.step(ps)
        _assert_states_equal(jsim, js, psim, ps)
