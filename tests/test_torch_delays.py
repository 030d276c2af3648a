"""Port parity for Maelstrom's per-hop latency on the node-major gather
path: the latency ring (``BroadcastSim(delays=)``, ``flood_step(delays=,
delay_set=)``, the state's ``history`` through ``state_from_numpy`` /
``state_to_numpy``) of gossip_glomers_tpu_torch against the JAX reference
on the CPU, alone and composed with partition windows and the nemesis
(crash, loss, dup).

Delays, specs and bitsets come from seeded numpy and go to both packages;
round counts, bitsets, the ring and the ``msgs`` / ``srv_msgs`` ledgers
compare exactly (tolerance 0).  The JAX sims are built with
``mesh=None``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import faults as pf


def _grid(n: int) -> np.ndarray:
    return jtop.to_padded_neighbors(jtop.grid(n))


def _line(n: int) -> np.ndarray:
    return jtop.to_padded_neighbors(jtop.line(n))


def _rand_delays(nbrs: np.ndarray, seed: int, hi: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(nbrs >= 0, rng.integers(1, hi, nbrs.shape),
                    1).astype(np.int32)


def _parts(n: int, start: int, end: int, low: int):
    """(JAX, port) Partitions: one window, nodes below ``low`` apart."""
    group = np.zeros((1, n), np.int8)
    group[0, :low] = 1
    return (jbc.Partitions(jnp.array([start], jnp.int32),
                           jnp.array([end], jnp.int32), jnp.asarray(group)),
            pbc.Partitions.from_numpy([start], [end], group))


def _ring_np(history) -> np.ndarray:
    """The reference's node-major (L, N, W) ring as uint32 numpy."""
    return np.asarray(history).astype(np.uint32)


def _same(jsim, js, psim, ps) -> None:
    assert ps.t == int(js.t)
    np.testing.assert_array_equal(psim.received_node_major(ps),
                                  jsim.received_node_major(js))
    assert int(ps.msgs) == int(js.msgs)
    assert (ps.srv_msgs is None) == (js.srv_msgs is None)
    if ps.srv_msgs is not None:
        assert int(ps.srv_msgs) == int(js.srv_msgs)
    np.testing.assert_array_equal(pbc.state_to_numpy(ps, words_major=False)[5],
                                  _ring_np(js.history))


def test_delay_one_equals_plain_path():
    n, nv = 25, 32
    nbrs = _grid(n)
    inject = pbc.make_inject(n, nv)
    s1, r1 = pbc.BroadcastSim(nbrs, n_values=nv, device="cpu").run(inject)
    sim = pbc.BroadcastSim(nbrs, n_values=nv, device="cpu",
                           delays=np.ones(nbrs.shape, np.int32))
    s2, r2 = sim.run(inject)
    assert r1 == r2
    assert torch.equal(s1.received, s2.received)
    assert int(s1.msgs) == int(s2.msgs)
    assert int(s1.srv_msgs) == int(s2.srv_msgs)
    ref = jbc.BroadcastSim(nbrs, n_values=nv,
                           delays=np.ones(nbrs.shape, np.int32))
    js, jr = ref.run(inject)
    assert jr == r2
    _same(ref, js, sim, s2)


def test_uniform_delay_scales_eccentricity():
    # a line with delay 3 on every edge: end to end takes 3 (n - 1) rounds
    n = 6
    nbrs = _line(n)
    delays = np.full(nbrs.shape, 3, np.int32)
    inject = pbc.make_inject(n, 1, origins=np.array([0]))
    sim = pbc.BroadcastSim(nbrs, n_values=1, sync_every=1 << 20,
                           delays=delays, device="cpu")
    state, rounds = sim.run(inject)
    assert rounds == 3 * (n - 1)
    assert (sim.received_node_major(state) == 1).all()
    assert sim.ring == 3 and state.history.shape == (3, n, 1)
    ref = jbc.BroadcastSim(nbrs, n_values=1, sync_every=1 << 20,
                           delays=delays)
    js, jr = ref.run(inject)
    assert jr == rounds
    _same(ref, js, sim, state)


def test_delays_with_partitions_heal():
    # drops are decided at send time; anti-entropy repairs after the
    # window lifts
    n = 6
    nbrs = _line(n)
    delays = np.full(nbrs.shape, 2, np.int32)
    jparts, pparts = _parts(n, 0, 6, 3)
    inject = pbc.make_inject(n, 1, origins=np.array([0]))
    sim = pbc.BroadcastSim(nbrs, n_values=1, sync_every=4, parts=pparts,
                           delays=delays, device="cpu")
    state, rounds = sim.run(inject)
    assert rounds > 6
    assert (sim.received_node_major(state) == 1).all()
    ref = jbc.BroadcastSim(nbrs, n_values=1, sync_every=4, parts=jparts,
                           delays=delays)
    js, jr = ref.run(inject)
    assert jr == rounds
    _same(ref, js, sim, state)


@pytest.mark.parametrize("sync_every", [3, 6])
@pytest.mark.parametrize("topology", ["tree", "grid", "random"])
def test_srv_msgs_on_sync_waves(topology, sync_every):
    # the server ledger under delays diffs against current state on every
    # sync wave, as the reference's does
    n, nv = 64, 40
    nbrs = {"tree": lambda: jtop.to_padded_neighbors(jtop.tree(n)),
            "grid": lambda: _grid(n),
            "random": lambda: jtop.random_regular(n, 4, seed=2)}[topology]()
    delays = _rand_delays(nbrs, seed=sync_every)
    inject = pbc.make_inject(n, nv)
    sim = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=sync_every,
                           delays=delays, device="cpu")
    state, rounds = sim.run(inject)
    ref = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=sync_every,
                           delays=delays)
    js, jr = ref.run(inject)
    assert jr == rounds
    assert state.srv_msgs is not None
    _same(ref, js, sim, state)


def test_partitions_delays_crash_loss_compose():
    # partition windows + per-edge delays + a crash window + loss in one
    # run, converging once everything clears
    n, nv = 16, 24
    nbrs = _grid(n)
    delays = _rand_delays(nbrs, seed=0)
    kw = dict(n_nodes=n, seed=3, crash=((4, 9, (1, 6)),), loss_rate=0.15,
              loss_until=12)
    jparts, pparts = _parts(n, 2, 9, n // 2)
    inject = pbc.make_inject(n, nv)
    sim = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=4, parts=pparts,
                           fault_plan=pf.NemesisSpec(**kw).compile("cpu"),
                           delays=delays, device="cpu")
    state, rounds = sim.run(inject, max_rounds=400)
    assert sim.converged(state, sim.target_bits(inject))
    assert rounds > pf.NemesisSpec(**kw).clear_round
    # a delayed run keeps no server ledger under a plan, as the reference
    assert state.srv_msgs is None
    ref = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=4, parts=jparts,
                           fault_plan=jf.NemesisSpec(**kw).compile(),
                           delays=delays)
    js, jr = ref.run(inject, max_rounds=400)
    assert jr == rounds
    _same(ref, js, sim, state)


def test_delayed_message_to_crashed_node_dies_in_flight():
    # node 1 goes down at round 2, exactly when node 0's round-0 flood
    # (edge delay 3) would land: after the restart the value is gone
    nbrs = np.array([[1], [0]], np.int32)
    delays = np.full((2, 1), 3, np.int32)
    kw = dict(n_nodes=2, seed=0, crash=((2, 5, (1,)),))
    inject = np.zeros((2, 1), np.uint32)
    inject[0, 0] = 1
    sim = pbc.BroadcastSim(nbrs, n_values=1, sync_every=1 << 20,
                           srv_ledger=False, delays=delays,
                           fault_plan=pf.NemesisSpec(**kw).compile("cpu"),
                           device="cpu")
    ref = jbc.BroadcastSim(nbrs, n_values=1, sync_every=1 << 20,
                           srv_ledger=False, delays=delays,
                           fault_plan=jf.NemesisSpec(**kw).compile())
    state, js = sim.init_state(inject), ref.init_state(inject)
    for _ in range(8):
        state, js = sim.step(state), ref.step(js)
        _same(ref, js, sim, state)
    rec = sim.received_node_major(state)
    assert rec[0, 0] == 1
    assert rec[1, 0] == 0, "a delivery to a dead process must not land"


def test_dup_under_delays_is_ledger_only():
    # a dup edge re-delivers its in-flight payload, which the dedup
    # absorbs: the same final state, a larger msgs ledger
    n, nv = 16, 24
    nbrs = _grid(n)
    delays = _rand_delays(nbrs, seed=0)
    base = dict(n_nodes=n, seed=7, crash=((3, 8, (2, 5)),), loss_rate=0.1,
                loss_until=10)
    dup = dict(base, dup_rate=0.4, dup_until=10)
    inject = pbc.make_inject(n, nv)

    def run(kw):
        sim = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=4,
                               delays=delays, srv_ledger=False,
                               fault_plan=pf.NemesisSpec(**kw).compile("cpu"),
                               device="cpu")
        return sim, *sim.run(inject)

    _, s1, r1 = run(base)
    sim2, s2, r2 = run(dup)
    assert r1 == r2
    assert torch.equal(s1.received, s2.received)
    assert int(s2.msgs) > int(s1.msgs)
    ref = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=4, delays=delays,
                           srv_ledger=False,
                           fault_plan=jf.NemesisSpec(**dup).compile())
    js, jr = ref.run(inject)
    assert jr == r2
    _same(ref, js, sim2, s2)


@pytest.mark.parametrize("case", ["plain", "parts", "nemesis", "dup"])
def test_flood_step_round_by_round(case):
    # flood_step(delays=, delay_set=) from a carried state (ring included,
    # through state_from_numpy), round by round, against the reference's
    n, nv = 32, 40
    nbrs = jtop.random_regular(n, 4, seed=5)
    delays = _rand_delays(nbrs, seed=11)
    jparts, pparts = _parts(n, 1, 6, n // 2)
    if case in ("plain", "nemesis", "dup"):
        jparts = jbc.Partitions(jnp.zeros((0,), jnp.int32),
                                jnp.zeros((0,), jnp.int32),
                                jnp.zeros((0, n), jnp.int8))
        pparts = pbc.Partitions.none(n)
    kw = dict(n_nodes=n, seed=9, crash=((2, 6, (0, 3, 17)),),
              loss_rate=0.2, loss_until=9)
    if case == "dup":
        kw.update(dup_rate=0.3, dup_until=9)
    jplan = pplan = None
    if case in ("nemesis", "dup"):
        jplan = jf.NemesisSpec(**kw).compile()
        pplan = pf.NemesisSpec(**kw).compile("cpu")
    dup_on = case == "dup"
    srv = None if dup_on else 0
    inject = pbc.make_inject(n, nv)
    ring = np.zeros((3, n, 2), np.uint32)
    js = jbc.BroadcastState(
        received=jnp.asarray(inject), frontier=jnp.asarray(inject),
        t=jnp.int32(0), msgs=jnp.uint32(0), history=jnp.asarray(ring),
        srv_msgs=None if srv is None else jnp.uint32(srv))
    ps = pbc.state_from_numpy(inject, inject, 0, 0, srv, "cpu",
                              words_major=False, history=ring)
    delay_set = tuple(int(v) for v in np.unique(delays))
    nb = torch.from_numpy(nbrs)
    for _ in range(10):
        js = jbc.flood_step(js, nbrs=jnp.asarray(nbrs),
                            nbr_mask=jnp.asarray(nbrs >= 0), parts=jparts,
                            sync_every=4, delays=jnp.asarray(delays),
                            delay_set=delay_set, plan=jplan, dup_on=dup_on)
        ps = pbc.flood_step(ps, nbrs=nb, nbr_mask=nb >= 0, parts=pparts,
                            sync_every=4, delays=torch.from_numpy(delays),
                            plan=pplan, dup_on=dup_on)
        rec, fr, t, msgs, srv_msgs, hist = pbc.state_to_numpy(
            ps, words_major=False)
        assert t == int(js.t) and msgs == int(js.msgs)
        np.testing.assert_array_equal(rec, np.asarray(js.received))
        np.testing.assert_array_equal(fr, np.asarray(js.frontier))
        np.testing.assert_array_equal(hist, _ring_np(js.history))
        assert srv_msgs == (None if js.srv_msgs is None
                            else int(js.srv_msgs))
        # the ring carries across the two packages bit for bit
        back = pbc.state_from_numpy(rec, fr, t, msgs, srv_msgs, "cpu",
                                    words_major=False, history=hist)
        assert torch.equal(back.history, ps.history)


def test_words_major_ring_round_trip():
    rng = np.random.default_rng(4)
    rec = rng.integers(0, 1 << 32, (9, 3), dtype=np.uint64).astype(np.uint32)
    ring = rng.integers(0, 1 << 32, (4, 9, 3),
                        dtype=np.uint64).astype(np.uint32)
    state = pbc.state_from_numpy(rec, rec, 5, 7, None, "cpu", history=ring)
    assert state.history.shape == (4, 3, 9)
    assert state.history.dtype == torch.int32
    np.testing.assert_array_equal(
        state.history.numpy().view(np.uint32), ring.transpose(0, 2, 1))
    np.testing.assert_array_equal(pbc.state_to_numpy(state)[5], ring)
    assert len(pbc.state_to_numpy(pbc.state_from_numpy(
        rec, rec, 5, 7, None, "cpu"))) == 5


def test_delay_mode_errors():
    n, nv = 16, 8
    nbrs = _grid(n)
    delays = np.full(nbrs.shape, 2, np.int32)
    with pytest.raises(ValueError, match="rounds >= 1"):
        pbc.BroadcastSim(nbrs, n_values=nv, device="cpu",
                         delays=np.zeros(nbrs.shape, np.int32))
    with pytest.raises(ValueError, match="match nbrs shape"):
        pbc.BroadcastSim(nbrs, n_values=nv, device="cpu",
                         delays=delays[:, :2])
    with pytest.raises(ValueError, match="union_block"):
        pbc.BroadcastSim(nbrs, n_values=nv, device="cpu", delays=delays,
                         srv_ledger=False, union_block=4,
                         fault_plan=pf.NemesisSpec(
                             n_nodes=n, seed=0, loss_rate=0.1,
                             loss_until=5).compile("cpu"))
    # the delay ring's provenance mode takes only a BroadcastProv record
    # (it stamps the ring's deliveries: tests/test_torch_provenance.py)
    with pytest.raises(TypeError, match="BroadcastProv"):
        state = pbc.BroadcastSim(nbrs, n_values=nv, device="cpu",
                                 delays=delays).init_state(
                                     pbc.make_inject(n, nv))
        nb = torch.from_numpy(nbrs)
        pbc.flood_step(state, nbrs=nb, nbr_mask=nb >= 0,
                       parts=pbc.Partitions.none(n), sync_every=4,
                       delays=torch.from_numpy(delays), prov=object())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        pbc.BroadcastSim(nbrs, n_values=nv, device="cpu", mesh=object())
