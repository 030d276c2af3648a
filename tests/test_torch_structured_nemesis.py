"""Port parity for the Maelstrom nemesis on the words-major structured
path: the delivery contract (``nemesis_dir_pairs``), ``_same_groups``,
``crash_down_rows``, the ``WMNemesisArrays`` operand, the ``wm_*``
evaluators, the ``make_nemesis`` closures and ``BroadcastSim(nemesis=,
fault_plan=)`` of gossip_glomers_tpu_torch against the JAX reference on
the CPU, and against the port's own node-major gather path under the same
plan.

Specs, groups and bitsets come from seeded numpy and go to both packages;
rows, bitsets, round counts and ledgers compare exactly (tolerance 0).
The port's mask rows are packed bits and are unpacked to compare with
the reference's bools.  The JAX sims are built with ``mesh=None``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst

# the reference's _NEM_TOPOLOGIES, with ring and line besides
TOPOLOGIES = [("tree", 64, {}),
              ("tree", 85, {"branching": 4}),     # ragged last level
              ("grid", 64, {}),
              ("circulant", 64, {"strides": [1, 5]}),
              ("ring", 32, {}),
              ("line", 32, {})]
TOPO_IDS = [f"{t}{n}" for t, n, _ in TOPOLOGIES]
# the contracts' cases: those of the partition tests
CONTRACT_CASES = [("tree", 64, {}), ("tree", 85, {"branching": 4}),
                  ("grid", 64, {}), ("grid", 60, {}), ("ring", 32, {}),
                  ("line", 32, {}),
                  ("circulant", 64, {"strides": jtop.expander_strides(64, 6,
                                                                      1)})]
# test_structured_nemesis_matches_gather_all_topologies' spec
SPEC = dict(seed=7, crash=((3, 8, (2, 5, 11)), (10, 13, (0, 1))),
            loss_rate=0.2, loss_until=14, dup_rate=0.15, dup_until=14)


def _nbrs(topo: str, n: int, kw: dict) -> np.ndarray:
    if topo == "circulant":
        return jtop.circulant(n, kw["strides"])
    if topo == "tree":
        return jtop.to_padded_neighbors(jtop.tree(n, kw.get("branching", 4)))
    build = {"grid": jtop.grid, "ring": jtop.ring, "line": jtop.line}[topo]
    return jtop.to_padded_neighbors(build(n))


def _specs(**kw):
    """(JAX NemesisSpec, port NemesisSpec) of one spec."""
    return jf.NemesisSpec(**kw), pf.NemesisSpec(**kw)


def _half_parts(n: int, start: int = 2, end: int = 9):
    """The reference's _half_parts: (JAX, port Partitions, groups)."""
    groups = np.zeros((1, n), np.int8)
    groups[0, : n // 2] = 1
    return (jbc.Partitions(jnp.array([start], jnp.int32),
                           jnp.array([end], jnp.int32), jnp.asarray(groups)),
            pbc.Partitions.from_numpy([start], [end], groups), groups)


def _bundles(topo, n, kw, jspec, pspec, groups):
    return (jst.make_nemesis(topo, n, jspec, groups=groups, **kw),
            pst.make_nemesis(topo, n, pspec, groups=groups, device="cpu",
                             **kw))


def _rows(x: torch.Tensor, n: int) -> np.ndarray:
    return kernels.unpack_bits(x, n).numpy()


@pytest.mark.parametrize("topo,n,kw", CONTRACT_CASES,
                         ids=[f"{t}{n}" for t, n, _ in CONTRACT_CASES])
def test_nemesis_contracts_match_reference(topo, n, kw):
    for got, want in zip(pst.nemesis_dir_pairs(topo, n, **kw),
                         jst.nemesis_dir_pairs(topo, n, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    src, dst, _ = jst.nemesis_dir_pairs(topo, n, **kw)
    rng = np.random.default_rng(n)
    for groups in (np.zeros((0, n), np.int8),
                   rng.integers(0, 3, (2, n)).astype(np.int8)):
        got = pst._same_groups(groups, src, dst, n)
        assert got.dtype == bool
        np.testing.assert_array_equal(got,
                                      jst._same_groups(groups, src, dst, n))
    jspec, pspec = _specs(n_nodes=n, seed=1,
                          crash=((1, 4, (0, 3, n - 1)), (2, 9, (5,))))
    for ids in (src, dst, np.arange(n), np.array([-1, 0, n - 1])):
        np.testing.assert_array_equal(pf.crash_down_rows(pspec, ids),
                                      jf.crash_down_rows(jspec, ids))
    assert pst.nemesis_dir_pairs("random", n) is None


@pytest.mark.parametrize("topo,n,kw", TOPOLOGIES, ids=TOPO_IDS)
def test_wm_arrays_match_reference(topo, n, kw):
    jspec, pspec = _specs(n_nodes=n, **SPEC)
    jnem, pnem = _bundles(topo, n, kw, jspec, pspec, _half_parts(n)[2])
    ja, pa = jnem.arrs, pnem.arrs
    assert pa.n_nodes == n and pnem.dir_delays is None and pnem.ring == 1
    for name in ("exists", "same", "down_pair", "deg_exists", "deg_same",
                 "deg_down_pair"):
        got = getattr(pa, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_rows(got, n),
                                      np.asarray(getattr(ja, name)), name)
    for name in ("src", "dst", "deg_src", "deg_dst"):
        got = getattr(pa, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ja, name)), name)
    np.testing.assert_array_equal(pa.down_cols.numpy(),
                                  np.asarray(ja.down_cols))


def _plans(jspec, pspec):
    return jspec.compile(), pspec.compile(device="cpu")


@pytest.mark.parametrize("topo,n,kw", TOPOLOGIES, ids=TOPO_IDS)
def test_wm_evaluators_match_reference(topo, n, kw):
    # t = 0, inside and after each crash window and the partition
    # window, and past loss_until / dup_until
    jspec, pspec = _specs(n_nodes=n, **SPEC)
    jparts, pparts, groups = _half_parts(n)
    jnem, pnem = _bundles(topo, n, kw, jspec, pspec, groups)
    jplan, pplan = _plans(jspec, pspec)
    ja, pa = jnem.arrs, pnem.arrs
    js, je = jparts.starts, jparts.ends
    ps, pe = pparts.starts, pparts.ends
    for t in (0, 1, 3, 5, 8, 9, 10, 12, 13, 14, 20):
        tj = jnp.int32(t)
        np.testing.assert_array_equal(
            pf.wm_up_cols(pplan, t, pa.down_cols).numpy(),
            np.asarray(jf.wm_up_cols(jplan, tj, ja.down_cols)))
        wipe = pf.wm_wipe_cols(pplan, t, pa.down_cols)
        want_wipe = np.asarray(
            ~jf.wm_up_cols(jplan, tj, ja.down_cols)
            & jf.wm_up_cols(jplan, tj - 1, ja.down_cols))
        np.testing.assert_array_equal(
            np.zeros(n, bool) if wipe is None else wipe.numpy(), want_wipe)
        for deg in (False, True):
            np.testing.assert_array_equal(
                _rows(pf.wm_live_rows(pplan, t, pa, ps, pe, deg=deg), n),
                np.asarray(jf.wm_live_rows(jplan, tj, ja, js, je, deg=deg)))
        for dup_on in (False, True):
            got = pf.wm_live_del(pplan, t, pa, ps, pe, dup_on)
            want = jf.wm_live_del(jplan, tj, ja, js, je, dup_on)
            np.testing.assert_array_equal(_rows(got[0], n),
                                          np.asarray(want[0]))
            if want[1] is None:
                assert got[1] is None
            else:            # None: the dup stream is off at t
                np.testing.assert_array_equal(
                    np.zeros(want[1].shape, bool) if got[1] is None
                    else _rows(got[1], n), np.asarray(want[1]))
        for g, w in zip(pf.wm_srv_rows(pplan, t, pa, ps, pe),
                        jf.wm_srv_rows(jplan, tj, ja, js, je)):
            np.testing.assert_array_equal(_rows(g, n), np.asarray(w))


@pytest.mark.parametrize("topo,n,kw", TOPOLOGIES, ids=TOPO_IDS)
def test_nemesis_closures_match_reference(topo, n, kw):
    # the delivery closure over packed rows (the masked kernels' plain
    # versions) against the reference's over bools, and the count moves
    jspec, pspec = _specs(n_nodes=n, **SPEC)
    jnem, pnem = _bundles(topo, n, kw, jspec, pspec, None)
    exists = np.array(jnem.arrs.exists)
    rng = np.random.default_rng(n)
    for w in (1, 3):
        x = rng.integers(0, 1 << 32, (w, n), dtype=np.uint64).astype(
            np.uint32)
        for live in (exists, exists & (rng.random(exists.shape) < 0.5)):
            want = np.asarray(jnem.exchange(lambda d: jnp.asarray(x),
                                            jnp.asarray(live)))
            got = pnem.exchange(torch.from_numpy(x.view(np.int32)),
                                kernels.pack_bits(torch.from_numpy(live)))
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    pc = rng.integers(0, 97, (1, n)).astype(np.uint32)
    for d in range(exists.shape[0]):
        np.testing.assert_array_equal(
            pnem.src_pc(d, torch.from_numpy(pc.astype(np.int32))).numpy(),
            np.asarray(jnem.src_pc(d, jnp.asarray(pc))).astype(np.int32))


def _sims(topo, n, kw, nv, spec_kw, windows=True, **sim_kw):
    """(JAX structured, port structured, port gather) sims of one plan."""
    jspec, pspec = _specs(n_nodes=n, **spec_kw)
    jparts, pparts, groups = _half_parts(n)
    if not windows:
        jparts = pparts = None
        groups = None
    nbrs = _nbrs(topo, n, kw)
    jnem, pnem = _bundles(topo, n, kw, jspec, pspec, groups)
    jsim = jbc.BroadcastSim(nbrs, n_values=nv, parts=jparts, mesh=None,
                            exchange=jst.make_exchange(topo, n, **kw),
                            fault_plan=jspec.compile(), nemesis=jnem,
                            **sim_kw)
    psim = pbc.BroadcastSim(nbrs, n_values=nv, parts=pparts, device="cpu",
                            exchange=pst.make_exchange(topo, n, **kw),
                            fault_plan=pspec.compile(device="cpu"),
                            nemesis=pnem, **sim_kw)
    gsim = pbc.BroadcastSim(nbrs, n_values=nv, parts=pparts, device="cpu",
                            fault_plan=pspec.compile(device="cpu"),
                            **sim_kw)
    return jsim, psim, gsim


def _assert_same(jsim, js, jr, psim, ps, pr):
    assert pr == jr
    np.testing.assert_array_equal(psim.received_node_major(ps),
                                  np.asarray(jsim.received_node_major(js)))
    assert ps.t == int(js.t)
    assert int(ps.msgs) == int(js.msgs)
    assert (ps.srv_msgs is None) == (js.srv_msgs is None)
    if js.srv_msgs is not None:
        assert psim.server_msgs(ps) == jsim.server_msgs(js)


@pytest.mark.parametrize("topo,n,kw", TOPOLOGIES, ids=TOPO_IDS)
def test_structured_nemesis_matches_reference_and_gather(topo, n, kw):
    # crash + loss + dup composed with a half/half partition window
    jsim, psim, gsim = _sims(topo, n, kw, 48, SPEC, sync_every=4,
                             srv_ledger=False)
    inject = jbc.make_inject(n, 48)
    js, jr = jsim.run(inject, max_rounds=300)
    _assert_same(jsim, js, jr, psim, *psim.run(inject, max_rounds=300))
    _assert_same(jsim, js, jr, gsim, *gsim.run(inject, max_rounds=300))
    assert psim.build_fixed(jr) is None
    state0, target = psim.stage(inject)
    fixed = psim.run_staged_fixed(state0, jr)
    _assert_same(jsim, js, jr, psim, fixed, fixed.t)
    assert psim.converged(fixed, target)


@pytest.mark.parametrize("topo", ("tree", "grid", "circulant"))
def test_loss_only_srv_ledger_matches_reference_and_gather(topo):
    # test_broadcast_srv_ledger_loss_only_words_major_matches_gather's
    # case (64 nodes, loss 0.25 until 10, seed 5), round by round, sync
    # waves included; the circulant under a partition window besides
    n, nv = 64, 48
    kw = {"strides": [1, 5]} if topo == "circulant" else {}
    spec = dict(seed=5, loss_rate=0.25, loss_until=10)
    jsim, psim, gsim = _sims(topo, n, kw, nv, spec,
                             windows=topo == "circulant", sync_every=4)
    assert psim._srv_on and gsim._srv_on
    inject = jbc.make_inject(n, nv)
    js, ps, gs = (s.init_state(inject) for s in (jsim, psim, gsim))
    for _ in range(12):
        js, ps, gs = jsim.step(js), psim.step(ps), gsim.step(gs)
        _assert_same(jsim, js, js.t, psim, ps, ps.t)
        _assert_same(jsim, js, js.t, gsim, gs, gs.t)


def test_nemesis_error_paths():
    n = 16
    nbrs = _nbrs("grid", n, {})
    jspec, pspec = _specs(n_nodes=n, seed=0, loss_rate=0.2, loss_until=4)
    jex, pex = jst.make_exchange("grid", n), pst.make_exchange("grid", n)
    jnem, pnem = _bundles("grid", n, {}, jspec, pspec, None)
    jplan, pplan = _plans(jspec, pspec)
    dev = {"device": "cpu"}
    # membership events and a spec for another n: the reference's words
    for bad in (dict(n_nodes=n, seed=0, join=((2, (3,)),)),
                dict(n_nodes=n + 1, seed=0)):
        with pytest.raises(ValueError) as want:
            jst.make_nemesis("grid", n, jf.NemesisSpec(**bad))
        with pytest.raises(ValueError) as got:
            pst.make_nemesis("grid", n, pf.NemesisSpec(**bad), **dev)
        assert str(got.value) == str(want.value)
    # construction: each refusal as the reference words it — a plan
    # without nemesis=, nemesis= without a plan, nemesis= on the gather
    # path, nemesis= with faulted=
    cases = [("exchange", "fault_plan"), ("exchange", "nemesis"),
             ("nemesis", "fault_plan"),
             ("exchange", "nemesis", "fault_plan", "faulted")]
    group = np.zeros((1, n), np.int8)
    for case in cases:
        words = []
        for mod, given, extra in (
                (jbc, dict(exchange=jex, nemesis=jnem, fault_plan=jplan,
                           faulted=jst.make_faulted("grid", n, group)),
                 {"mesh": None}),
                (pbc, dict(exchange=pex, nemesis=pnem, fault_plan=pplan,
                           faulted=pst.make_faulted("grid", n, group)),
                 dev)):
            with pytest.raises(ValueError) as err:
                mod.BroadcastSim(nbrs, n_values=8, **extra,
                                 **{k: given[k] for k in case})
            words.append(str(err.value))
        assert words[1] == words[0], case
    # a dup stream with the ledger on
    jd, pd = _specs(n_nodes=n, seed=0, dup_rate=0.1, dup_until=4)
    with pytest.raises(ValueError, match="dup stream"):
        pbc.BroadcastSim(nbrs, n_values=8, exchange=pex, device="cpu",
                         nemesis=pst.make_nemesis("grid", n, pd, **dev),
                         fault_plan=pd.compile(device="cpu"))
    # a crash plan keeps the words-major ledger off, loss-only keeps it
    crash = pf.NemesisSpec(n_nodes=n, seed=0, crash=((1, 3, (2,)),))
    sim = pbc.BroadcastSim(nbrs, n_values=8, exchange=pex, device="cpu",
                           nemesis=pst.make_nemesis("grid", n, crash, **dev),
                           fault_plan=crash.compile(device="cpu"))
    state = sim.step(sim.init_state(np.zeros((n, 1), np.uint32)))
    with pytest.raises(ValueError, match="loss-only"):
        sim.server_msgs(state)
    sim = pbc.BroadcastSim(nbrs, n_values=8, exchange=pex, device="cpu",
                           nemesis=pnem, fault_plan=pplan)
    assert sim.server_msgs(
        sim.step(sim.init_state(np.zeros((n, 1), np.uint32)))) >= 0
    # a bundle of another spec's crash windows
    with pytest.raises(ValueError, match="crash masks"):
        pbc.BroadcastSim(nbrs, n_values=8, exchange=pex, device="cpu",
                         nemesis=pnem, fault_plan=crash.compile("cpu"))
    # per-direction delays build their ring bundle; the halo closures
    # are not ported
    with pytest.raises(ValueError, match="direction delays"):
        pst.make_nemesis("grid", n, pspec, dir_delays=(1, 2), **dev)
    delayed = pst.make_nemesis("grid", n, pspec, dir_delays=(1, 2, 1, 1),
                               **dev)
    assert delayed.dir_delays == (1, 2, 1, 1) and delayed.ring == 2
    assert delayed.ring_exchange is not None
    # n_shards: the halo closures where the halo gates pass
    halo = pst.make_nemesis("grid", n, pspec, n_shards=2, **dev)
    assert (halo.sharded_exchange is not None) \
        == (halo.sharded_src_pc is not None) \
        == pst.has_sharded_exchange("grid", n, 2)
    assert pst.make_nemesis("random", n, pspec, **dev) is None
