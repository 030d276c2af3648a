"""The slice as a whole: the port's words-major tree-flood BroadcastSim
against the JAX reference's, run on the CPU.

Both sims take the same ``make_inject`` workload; the JAX sims are built
with ``mesh=None`` explicitly (conftest forces an 8-device virtual CPU
mesh that ``timing.structured_sim`` would otherwise pick up).  Rounds,
received bitsets and the ``msgs`` / ``srv_msgs`` ledgers compare exactly
(tolerance 0).
"""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel.topology import to_padded_neighbors, tree
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import structured as jst
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
