"""Port parity for the node-major gather path: partition windows
(``_edge_live``), the adjacency gather (``_gather_or``), the sync-wave diff
(``_sync_diff_pc``), one round (``flood_step``) and the gather-path
``BroadcastSim`` of gossip_glomers_tpu_torch against the JAX reference on
the CPU.

Inputs (adjacency, partition groups, bitsets) come from seeded numpy and
go to both packages; bitsets, round counts and the ``msgs`` / ``srv_msgs``
ledgers compare exactly (tolerance 0).  The JAX sims are built with
``mesh=None`` explicitly (conftest forces an 8-device virtual CPU mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim.structured import make_exchange as jex
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import provenance as pprov
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import timing as ptiming

N = 96


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _parts(n: int, windows, seed: int = 3):
    """The same schedule for both packages: (JAX Partitions, port
    Partitions)."""
    rng = np.random.default_rng(seed)
    group = rng.integers(0, 3, (len(windows), n)).astype(np.int8)
    starts = np.array([a for a, _ in windows], np.int32)
    ends = np.array([b for _, b in windows], np.int32)
    return (jbc.Partitions(jnp.asarray(starts), jnp.asarray(ends),
                           jnp.asarray(group)),
            pbc.Partitions.from_numpy(starts, ends, group))


def _nbrs(topology: str, n: int = N) -> np.ndarray:
    if topology == "tree":
        return jtop.to_padded_neighbors(jtop.tree(n))
    if topology == "circulant":
        return jtop.circulant(n, jtop.expander_strides(n, 8, seed=0))
    return jtop.random_regular(n, 4, seed=1)


WINDOWS = {0: [], 1: [(2, 6)], 3: [(1, 3), (2, 9), (5, 7)]}


@pytest.mark.parametrize("n_windows", (0, 1, 3))
def test_edge_live_matches_reference(n_windows):
    nbrs = _nbrs("tree")          # ragged: pad edges stay dead
    jp, pp = _parts(N, WINDOWS[n_windows])
    row_ids = np.arange(N, dtype=np.int32)
    nbrs_t = torch.from_numpy(nbrs)
    mask_t = nbrs_t >= 0
    for t in range(0, 11):
        want = np.asarray(jbc._edge_live(jnp.int32(t), jnp.asarray(row_ids),
                                         jnp.asarray(nbrs),
                                         jnp.asarray(nbrs >= 0), jp))
        got = pbc._edge_live(t, torch.from_numpy(row_ids).long(), nbrs_t,
                             mask_t, pp)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t={t}")
        if not pp.active(t):
            assert got is mask_t          # no window: nothing is built


@pytest.mark.parametrize("w", (1, 3))
@pytest.mark.parametrize("topology", ("tree", "random_regular"))
def test_gather_or_and_sync_diff_match_reference(topology, w):
    nbrs = _nbrs(topology)
    payload, recv = _u32((N, w), 1), _u32((N, w), 2)
    live = np.random.default_rng(4).integers(0, 2, nbrs.shape).astype(bool)
    # a live pad edge reads row 0 in both (clip, then mask)
    live_pads = live | (nbrs < 0)
    pt, rt, nt = _torch(payload), _torch(recv), torch.from_numpy(nbrs)
    gather = jax.jit(jbc._gather_or)
    diff = jax.jit(jbc._sync_diff_pc)
    for lv in (nbrs >= 0, live, live_pads):
        lj = jnp.asarray(lv)
        want = np.asarray(gather(jnp.asarray(payload), jnp.asarray(nbrs),
                                 lj))
        np.testing.assert_array_equal(
            _bits(pbc._gather_or(pt, nt, torch.from_numpy(lv))), want)
        want_d = int(diff(jnp.asarray(payload), jnp.asarray(recv),
                          jnp.asarray(nbrs), lj))
        assert int(pbc._sync_diff_pc(pt, rt, nt, torch.from_numpy(lv))) \
            == want_d
    # live=None delivers exactly the edges with nbrs >= 0
    lj = jnp.asarray(nbrs >= 0)
    np.testing.assert_array_equal(
        _bits(pbc._gather_or(pt, nt, None)),
        np.asarray(gather(jnp.asarray(payload), jnp.asarray(nbrs), lj)))
    assert int(pbc._sync_diff_pc(pt, rt, nt, None)) == int(
        diff(jnp.asarray(payload), jnp.asarray(recv), jnp.asarray(nbrs),
             lj))


@pytest.mark.parametrize("n_src", (N, N + 37))
@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("w", (1, 3, 8))
def test_gather_flood_round_matches_reference(w, masked, n_src):
    # the fused round: new = _gather_or(payload, nbrs, live) & ~rec and
    # rec | new, on -1-padded tables, with and without an edge mask, and
    # with a payload covering more rows than nbrs
    rng = np.random.default_rng(10 * w + masked)
    nbrs = rng.integers(-1, n_src, (N, 5)).astype(np.int32)
    live = (rng.integers(0, 2, nbrs.shape).astype(bool) if masked
            else nbrs >= 0)
    payload, rec = _u32((n_src, w), 7), _u32((N, w), 8)
    inbox = np.asarray(jax.jit(jbc._gather_or)(
        jnp.asarray(payload), jnp.asarray(nbrs), jnp.asarray(live)))
    want_new = inbox & ~rec
    before = dict(kernels.LAUNCHES)
    new, rec_next = kernels.gather_flood_round(
        _torch(payload), _torch(rec), torch.from_numpy(nbrs),
        torch.from_numpy(live) if masked else None)
    np.testing.assert_array_equal(_bits(new), want_new)
    np.testing.assert_array_equal(_bits(rec_next), rec | want_new)
    assert kernels.LAUNCHES == before          # the CPU takes the plain one
    # a sync round's payload is rec itself: out of place, one hop
    new2, rec2 = kernels.gather_flood_round(
        _torch(rec), _torch(rec), torch.from_numpy(nbrs[:, :3].copy()))
    inbox2 = np.asarray(jax.jit(jbc._gather_or)(
        jnp.asarray(rec), jnp.asarray(nbrs[:, :3]),
        jnp.asarray(nbrs[:, :3] >= 0)))
    np.testing.assert_array_equal(_bits(new2), inbox2 & ~rec)
    np.testing.assert_array_equal(_bits(rec2), rec | (inbox2 & ~rec))


def test_sync_diff_wraps_mod_2_32():
    # every edge of an all-ones payload against empty receivers pushes 32
    # bits a word: 3 * 2^13 rows x 32 edges x 256 words x 32 bits =
    # 3 * 2^31, which the reference's uint32 sum wraps to 2^31
    n, d, w = 3 << 13, 32, 256
    payload = torch.full((n, w), -1, dtype=torch.int32)
    recv = torch.zeros((n, w), dtype=torch.int32)
    nbrs = torch.from_numpy(np.tile(np.arange(d, dtype=np.int32), (n, 1)))
    assert int(kernels.sync_diff_pc(payload, recv, nbrs)) == 1 << 31
    assert int(kernels.sync_diff_pc(payload[:4, :1].contiguous(),
                                    recv[:4, :1].contiguous(),
                                    nbrs[:4, :3].contiguous())) == 4 * 3 * 32


@pytest.mark.parametrize("w,per_block", ((1, 256), (3, 64), (8, 128),
                                         (32, 32), (128, 8), (256, 8)))
def test_gather_nodes_per_block(w, per_block):
    # a 256-thread block gives each node row a lane per 16-byte vector
    # (W % 4 == 0) or per word, rounded up to a power of two, at most 32
    assert kernels.gather_nodes_per_block(w) == per_block


@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("n_windows", (0, 1, 3))
def test_flood_step_matches_reference(n_windows, srv):
    nbrs = _nbrs("random_regular")
    jp, pp = _parts(N, WINDOWS[n_windows])
    inject = jbc.make_inject(N, 70)
    # ledgers carried in just below 2^32: the first rounds wrap them
    msgs0, srv0 = (1 << 32) - 1000, (1 << 32) - 77
    js = jbc.BroadcastState(received=jnp.asarray(inject),
                            frontier=jnp.asarray(inject), t=jnp.int32(0),
                            msgs=jnp.uint32(msgs0),
                            srv_msgs=jnp.uint32(srv0) if srv else None)
    ps = pbc.state_from_numpy(inject, inject, 0, msgs0,
                              srv0 if srv else None, "cpu",
                              words_major=False)
    step = jax.jit(lambda s: jbc.flood_step(
        s, nbrs=jnp.asarray(nbrs), nbr_mask=jnp.asarray(nbrs >= 0),
        parts=jp, sync_every=3))
    nbrs_t = torch.from_numpy(nbrs)
    for _ in range(9):               # sync rounds at t = 3 and 6
        js = step(js)
        ps = pbc.flood_step(ps, nbrs=nbrs_t, nbr_mask=nbrs_t >= 0,
                            parts=pp, sync_every=3)
        np.testing.assert_array_equal(_bits(ps.received),
                                      np.asarray(js.received))
        np.testing.assert_array_equal(_bits(ps.frontier),
                                      np.asarray(js.frontier))
        assert ps.t == int(js.t)
        assert int(ps.msgs) == int(js.msgs)
        if srv:
            assert int(ps.srv_msgs) == int(js.srv_msgs)
    assert int(js.msgs) < msgs0                # the ledger wrapped


def test_flood_step_unported_modes_raise():
    # the provenance mode takes only a BroadcastProv record (and stamps
    # it: tests/test_torch_provenance.py); the fault and delay modes run
    # (without a plan, dup_on and union_block leave the round as it is,
    # as in the reference; without delays so does a delay_set, and
    # one-round delays on a state with its ring deliver what the one-hop
    # round does)
    nbrs = torch.from_numpy(_nbrs("tree"))
    inject = jbc.make_inject(N, 40)
    state = pbc.state_from_numpy(inject, inject, 0, 0, None, "cpu",
                                 words_major=False)
    kw = dict(nbrs=nbrs, nbr_mask=nbrs >= 0, parts=pbc.Partitions.none(N),
              sync_every=3)
    with pytest.raises(TypeError, match="BroadcastProv"):
        pbc.flood_step(state, **kw, prov=object())
    plain = pbc.flood_step(state, **kw)
    prov = pprov.init_broadcast(N, 40, inject, device="cpu")
    stamped, prov = pbc.flood_step(state, **kw, prov=prov)
    assert torch.equal(stamped.received, plain.received)
    assert int((prov.arrival == 1).sum()) == int(
        kernels.col_popcount(plain.frontier, node_major=True).sum())
    ring = pbc.state_from_numpy(inject, inject, 0, 0, None, "cpu",
                                words_major=False,
                                history=np.zeros((1,) + inject.shape,
                                                 np.uint32))
    for st, mode in ((state, {"dup_on": True}), (state, {"union_block": 8}),
                     (state, {"plan": None, "dup_on": True,
                              "union_block": 8}),
                     (state, {"delay_set": (1, 2)}),
                     (ring, {"delays": torch.ones(nbrs.shape,
                                                  dtype=torch.int32)})):
        got = pbc.flood_step(st, **kw, **mode)
        assert torch.equal(got.received, plain.received)
        assert int(got.msgs) == int(plain.msgs)


def _assert_same(jsim, jstate, psim, pstate):
    np.testing.assert_array_equal(psim.received_node_major(pstate),
                                  np.asarray(jsim.received_node_major(
                                      jstate)))
    assert pstate.t == int(jstate.t)
    assert int(pstate.msgs) == int(jstate.msgs)
    assert (pstate.srv_msgs is None) == (jstate.srv_msgs is None)
    if jstate.srv_msgs is not None:
        assert psim.server_msgs(pstate) == jsim.server_msgs(jstate)


@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("n_windows", (0, 1))
@pytest.mark.parametrize("topology", ("tree", "circulant",
                                      "random_regular"))
def test_gather_sim_matches_reference(topology, n_windows, srv):
    nbrs = _nbrs(topology)
    jp, pp = _parts(N, WINDOWS[n_windows])
    jsim = jbc.BroadcastSim(nbrs, n_values=70, sync_every=4, parts=jp,
                            srv_ledger=srv, mesh=None)
    psim = pbc.BroadcastSim(nbrs, n_values=70, sync_every=4, parts=pp,
                            srv_ledger=srv, device="cpu")
    assert not psim.words_major and psim.build_fixed(3) is None
    inject = jbc.make_inject(N, 70)
    jref, jrounds = jsim.run_fused(inject)
    pref, prounds = psim.run_fused(inject)
    assert prounds == jrounds
    _assert_same(jsim, jref, psim, pref)
    # the generic fixed-trip runner stops at the same state
    ps0, target = psim.stage(inject)
    pfix = psim.run_staged_fixed(ps0, jrounds)
    _assert_same(jsim, jref, psim, pfix)
    assert psim.converged(pfix, target)
    np.testing.assert_array_equal(psim.received_node_major(ps0), inject)
    # the host-stepped runner agrees too
    prun, prun_rounds = psim.run(inject)
    assert prun_rounds == jrounds
    _assert_same(jsim, jref, psim, prun)


def test_partitioned_gather_sim_heals_through_anti_entropy():
    # a window over the flood's whole life: only sync waves after the heal
    # finish the broadcast, so the run outlasts the window
    nbrs = _nbrs("random_regular")
    jp, pp = _parts(N, [(1, 12)], seed=7)
    inject = jbc.make_inject(N, 70)
    jsim = jbc.BroadcastSim(nbrs, n_values=70, sync_every=5, parts=jp,
                            mesh=None)
    psim = pbc.BroadcastSim(nbrs, n_values=70, sync_every=5, parts=pp,
                            device="cpu")
    jref, jrounds = jsim.run_fused(inject)
    pref, prounds = psim.run_fused(inject)
    assert prounds == jrounds > 12
    _assert_same(jsim, jref, psim, pref)


@pytest.mark.parametrize("srv", (False, True))
def test_gather_circulant_equals_structured_circulant(srv):
    n, nv = 200, 64
    strides = jtop.expander_strides(n, 8, seed=0)
    gather = pbc.BroadcastSim(jtop.circulant(n, strides), n_values=nv,
                              sync_every=3, srv_ledger=srv, device="cpu")
    struct = ptiming.structured_sim("circulant", n, nv, strides=strides,
                                    sync_every=3, srv_ledger=srv,
                                    device="cpu")
    inject = jbc.make_inject(n, nv)
    gs, gr = gather.run_fused(inject)
    ss, sr = struct.run_fused(inject)
    assert gr == sr
    np.testing.assert_array_equal(gather.received_node_major(gs),
                                  struct.received_node_major(ss))
    assert int(gs.msgs) == int(ss.msgs)
    if srv:
        assert gather.server_msgs(gs) == struct.server_msgs(ss)


def test_node_major_state_round_trip():
    rec = _u32((37, 3), 5)
    fr = rec & _u32((37, 3), 6)
    state = pbc.state_from_numpy(rec, fr, 4, (1 << 32) + 3, 7, "cpu",
                                 words_major=False)
    assert state.received.shape == (37, 3)
    back = pbc.state_to_numpy(state, words_major=False)
    np.testing.assert_array_equal(back[0], rec)
    np.testing.assert_array_equal(back[1], fr)
    assert back[2:] == (4, 3, 7)


def test_partitions_constructors():
    none = pbc.Partitions.none(5)
    assert none.n_windows == 0 and none.group.shape == (0, 5)
    assert none.active(3) == []
    p = pbc.Partitions.from_numpy(np.array([2, 5]), np.array([4, 9]),
                                  np.zeros((2, 5), np.int8))
    assert (p.starts, p.ends) == ((2, 5), (4, 9))
    assert [p.active(t) for t in (1, 2, 4, 5, 9)] == [[], [0], [], [1], []]
    with pytest.raises(ValueError, match="group"):
        pbc.Partitions.from_numpy(np.array([2]), np.array([4]),
                                  np.zeros((2, 5), np.int8))
    with pytest.raises(ValueError, match="not"):
        pbc.BroadcastSim(_nbrs("tree"), n_values=4, parts=p, device="cpu")


def test_structured_path_with_windows_raises():
    n = 16
    jp, pp = _parts(n, [(1, 3)])
    # without its masked closures, as the reference words it
    nbrs = jtop.to_padded_neighbors(jtop.ring(n))
    with pytest.raises(ValueError, match="masked closures") as want:
        jbc.BroadcastSim(nbrs, n_values=4, parts=jp, mesh=None,
                         exchange=jex("ring", n))
    with pytest.raises(ValueError, match="masked closures") as got:
        pbc.BroadcastSim(nbrs, n_values=4, parts=pp, device="cpu",
                         exchange=pst.make_exchange("ring", n))
    assert str(got.value) == str(want.value)
    pbc.BroadcastSim(nbrs, n_values=4, parts=pp, device="cpu",
                     exchange=pst.make_exchange("ring", n),
                     faulted=pst.make_faulted(
                         "ring", n, pp.group.numpy()))
    # an empty schedule is the reference's default and is accepted
    pbc.BroadcastSim(jtop.to_padded_neighbors(jtop.ring(n)), n_values=4,
                     parts=pbc.Partitions.none(n), device="cpu",
                     exchange=pst.make_exchange("ring", n))


def test_gather_sync_wave_round_matches_reference():
    # every step of a sync_every = 2 run, srv ledger on, under a window
    nbrs = _nbrs("circulant")
    jp, pp = _parts(N, [(2, 5)])
    jsim = jbc.BroadcastSim(nbrs, n_values=40, sync_every=2, parts=jp,
                            mesh=None)
    psim = pbc.BroadcastSim(nbrs, n_values=40, sync_every=2, parts=pp,
                            device="cpu")
    inject = jbc.make_inject(N, 40)
    js, ps = jsim.init_state(inject), psim.init_state(inject)
    for _ in range(7):
        js, ps = jsim.step(js), psim.step(ps)
        _assert_same(jsim, js, psim, ps)
        np.testing.assert_array_equal(_bits(ps.frontier),
                                      np.asarray(js.frontier))
