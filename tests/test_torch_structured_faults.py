"""Port parity for partition schedules on the words-major structured path:
the direction-row contracts (``fault_dir_senders``, ``fault_masks``), the
packed liveness rows, the four masked exchanges and masked sync diffs,
the ``make_faulted`` bundle and ``BroadcastSim(parts=, faulted=)`` of
gossip_glomers_tpu_torch against the JAX reference on the CPU, and
against the port's own node-major gather path on the same schedule.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages;
bitsets, rows, round counts and the ``msgs`` / ``srv_msgs`` ledgers
compare exactly (tolerance 0).  The JAX sims are built with ``mesh=None``
(conftest forces an 8-device virtual CPU mesh).  The cases are those of
the reference's test_faulted_structured_matches_gather_all_topologies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import timing as ptiming

CASES = [("tree", 64, {}),
         ("tree", 85, {"branching": 4}),          # ragged last level
         ("grid", 64, {}),
         ("grid", 60, {}),                        # ragged last row
         ("ring", 32, {}),
         ("line", 32, {}),
         ("circulant", 64, {"strides": jtop.expander_strides(64, 6, 1)})]
CASE_IDS = [f"{t}{n}" for t, n, _ in CASES]


def _nbrs(topo: str, n: int, kw: dict) -> np.ndarray:
    if topo == "circulant":
        return jtop.circulant(n, kw["strides"])
    if topo == "tree":
        return jtop.to_padded_neighbors(jtop.tree(n, kw.get("branching", 4)))
    if topo == "grid":
        return jtop.to_padded_neighbors(jtop.grid(n, kw.get("cols")))
    build = {"ring": jtop.ring, "line": jtop.line}[topo]
    return jtop.to_padded_neighbors(build(n))


def _window_sets(n: int, seed: int):
    """The reference's _fault_cases: single, overlapping and repeated
    windows with varied group shapes, as [(start, end, group row)]."""
    rng = np.random.default_rng(seed)
    half = np.zeros(n, np.int8)
    half[: n // 2] = 1
    thirds = (np.arange(n) * 3 // n).astype(np.int8)
    rand = rng.integers(0, 2, n).astype(np.int8)
    return [[(0, 6, half)],
            [(2, 8, thirds), (5, 12, rand)],
            [(0, 4, rand), (9, 14, half)]]


def _parts(wins):
    """(JAX Partitions, port Partitions, (P, N) groups) of a window set."""
    starts = np.array([w[0] for w in wins], np.int32)
    ends = np.array([w[1] for w in wins], np.int32)
    group = np.stack([w[2] for w in wins]).astype(np.int8)
    return (jbc.Partitions(jnp.asarray(starts), jnp.asarray(ends),
                           jnp.asarray(group)),
            pbc.Partitions.from_numpy(starts, ends, group), group)


def _u32(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("topo,n,kw", CASES, ids=CASE_IDS)
def test_direction_contracts_match_reference(topo, n, kw):
    want = jst.fault_dir_senders(topo, n, **kw)
    got = pst.fault_dir_senders(topo, n, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for wins in _window_sets(n, seed=n):
        group = _parts(wins)[2]
        for g, w in zip(pst.fault_masks(topo, n, group, **kw),
                        jst.fault_masks(topo, n, group, **kw)):
            assert g.dtype == w.dtype == bool
            np.testing.assert_array_equal(g, w)
    assert pst.fault_dir_senders("random", n) is None
    assert pst.fault_masks("random", n, np.zeros((1, n), np.int8)) is None


@pytest.mark.parametrize("n", (1, 5, 31, 32, 33, 64, 100))
def test_packed_rows_round_trip(n):
    rows = np.random.default_rng(n).random((3, n)) < 0.5
    packed = kernels.pack_bits(torch.from_numpy(rows))
    assert packed.dtype == torch.int32
    assert packed.shape == (3, kernels.packed_words(n))
    # node i at bit i % 32 of word i // 32: numpy's little bit order
    want = np.packbits(np.pad(rows, ((0, 0), (0, 32 * packed.shape[1] - n))),
                       axis=1, bitorder="little").view(np.uint32)
    np.testing.assert_array_equal(_bits(packed), want)
    np.testing.assert_array_equal(kernels.unpack_bits(packed, n).numpy(),
                                  rows)
    np.testing.assert_array_equal(kernels.count_rows(packed, n).numpy(),
                                  rows.sum(0))


def _masked_fns(topo: str, n: int, kw: dict):
    """(JAX, port) masked exchange and sync diff over bool (D, N) rows."""
    if topo == "tree":
        k = kw.get("branching", 4)
        return ((lambda p, lv: jst.tree_masked_exchange(p, lv, k),
                 lambda r, lv: jst.tree_masked_sync_diff(r, lv, k)),
                (lambda p, lv: pst.tree_masked_exchange(p, lv, k),
                 lambda r, lv: pst.tree_masked_sync_diff(r, lv, k)))
    if topo == "grid":
        cols = kw.get("cols") or jtop.grid_cols(n)
        return ((lambda p, lv: jst.grid_masked_exchange(p, lv, cols),
                 lambda r, lv: jst.grid_masked_sync_diff(r, lv, cols)),
                (lambda p, lv: pst.grid_masked_exchange(p, lv, cols),
                 lambda r, lv: pst.grid_masked_sync_diff(r, lv, cols)))
    if topo == "line":
        return ((jst.line_masked_exchange, jst.line_masked_sync_diff),
                (pst.line_masked_exchange, pst.line_masked_sync_diff))
    strides = [1] if topo == "ring" else list(kw["strides"])
    return ((lambda p, lv: jst.circulant_masked_exchange(p, lv, strides),
             lambda r, lv: jst.circulant_masked_sync_diff(r, lv, strides)),
            (lambda p, lv: pst.circulant_masked_exchange(p, lv, strides),
             lambda r, lv: pst.circulant_masked_sync_diff(r, lv, strides)))


@pytest.mark.parametrize("w", (1, 3))
@pytest.mark.parametrize("topo,n,kw", CASES, ids=CASE_IDS)
def test_masked_exchanges_and_diffs_match_reference(topo, n, kw, w):
    (jex, jdf), (pex, pdf) = _masked_fns(topo, n, kw)
    exists = jst.fault_dir_senders(topo, n, **kw) >= 0
    bundle = pst.make_faulted(topo, n, np.zeros((1, n), np.int8), **kw)
    for seed in range(3):
        x = _u32((w, n), seed=100 * n + 10 * w + seed)
        rng = np.random.default_rng(seed)
        # random rows, then the realistic ones (a window's live rows are
        # always within exists, which carries the grid's column masks)
        for live in (rng.random(exists.shape) < 0.6,
                     exists & (rng.random(exists.shape) < 0.6),
                     exists, np.zeros_like(exists)):
            want_in = np.asarray(jex(jnp.asarray(x), jnp.asarray(live)))
            want_df = int(jdf(jnp.asarray(x), jnp.asarray(live)))
            lv = torch.from_numpy(live)
            np.testing.assert_array_equal(_bits(pex(_torch(x), lv)),
                                          want_in)
            assert int(pdf(_torch(x), lv)) == want_df
            if (live & ~exists).any():
                continue
            # the bundle's closures over the packed rows (the kernels'
            # plain versions on the CPU) give the same
            packed = kernels.pack_bits(lv)
            np.testing.assert_array_equal(
                _bits(bundle.exchange(_torch(x), packed)), want_in)
            assert int(bundle.sync_diff(_torch(x), packed)) == want_df


def test_masked_kernel_wrappers_match_the_bool_forms():
    # each wrapper's packed rows against the bool rows it unpacks to:
    # the tree's two rows apart (the nemesis gates parent and kids
    # edges separately), the shift table row by row
    n, k = 85, 4
    x = _torch(_u32((3, n), seed=9))
    rng = np.random.default_rng(9)
    mp, mk = (torch.from_numpy(rng.random(n) < 0.5) for _ in range(2))
    got = kernels.tree_masked_exchange(x, kernels.pack_bits(mp),
                                       kernels.pack_bits(mk), k)
    assert torch.equal(got, pst.tree_masked_terms(x, mp, mk, k))
    both = torch.stack([mp, mp])
    assert torch.equal(pst.tree_masked_exchange(x, both, k),
                       pst.tree_masked_terms(x, mp, mp, k))
    for topo, kw in (("grid", {"cols": 9}), ("line", {}),
                     ("circulant", {"strides": [1, 7, 20]})):
        dirs = pst.shift_dirs(topo, n, **kw)
        exists = torch.from_numpy(pst.fault_dir_senders(topo, n, **kw) >= 0)
        live = exists & torch.from_numpy(rng.random(tuple(exists.shape))
                                         < 0.5)
        want = torch.zeros_like(x)
        for d in range(len(dirs.offs)):
            want |= torch.where(live[d][None, :],
                                kernels.shift_term_plain(x, dirs, d), 0)
        got = kernels.shift_masked_exchange(x, kernels.pack_bits(live), dirs)
        assert torch.equal(got, want), topo
        # all rows live: the unmasked exchange
        assert torch.equal(
            kernels.shift_masked_exchange(x, kernels.pack_bits(exists),
                                          dirs),
            kernels.shift_exchange(x, dirs)), topo
    with pytest.raises(ValueError, match="packed int32 rows"):
        kernels.shift_masked_exchange(x, kernels.pack_bits(live[:1]), dirs)
    with pytest.raises(ValueError, match="packed int32 rows"):
        kernels.tree_masked_exchange(x, mp, mk, k)


def _assert_runs(jsim, js, jr, psim, ps, pr, srv=True):
    assert pr == jr
    np.testing.assert_array_equal(psim.received_node_major(ps),
                                  np.asarray(jsim.received_node_major(js)))
    assert ps.t == int(js.t)
    assert int(ps.msgs) == int(js.msgs)
    if srv:
        assert psim.server_msgs(ps) == jsim.server_msgs(js)


@pytest.mark.parametrize("topo,n,kw", CASES, ids=CASE_IDS)
def test_faulted_sim_matches_reference_and_gather(topo, n, kw):
    nbrs = _nbrs(topo, n, kw)
    nv = min(n, 48)
    inject = jbc.make_inject(n, nv)
    for wins in _window_sets(n, seed=n):
        jparts, pparts, group = _parts(wins)
        jsim = jbc.BroadcastSim(
            nbrs, n_values=nv, sync_every=4, parts=jparts, mesh=None,
            exchange=jst.make_exchange(topo, n, **kw),
            faulted=jst.make_faulted(topo, n, group, **kw))
        jstate, jrounds = jsim.run(inject)
        psim = pbc.BroadcastSim(
            nbrs, n_values=nv, sync_every=4, parts=pparts, device="cpu",
            exchange=pst.make_exchange(topo, n, **kw),
            faulted=pst.make_faulted(topo, n, group, **kw))
        assert psim._srv_on and psim.words_major
        _assert_runs(jsim, jstate, jrounds, psim, *psim.run(inject))
        _assert_runs(jsim, jstate, jrounds, psim, *psim.run_fused(inject))
        # the fixed-trip runner takes the generic round loop
        assert psim.build_fixed(jrounds) is None
        state0, target = psim.stage(inject)
        fixed = psim.run_staged_fixed(state0, jrounds)
        _assert_runs(jsim, jstate, jrounds, psim, fixed, fixed.t)
        # the port's gather path on the same schedule
        gsim = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=4,
                                parts=pparts, device="cpu")
        _assert_runs(jsim, jstate, jrounds, gsim, *gsim.run(inject))


@pytest.mark.parametrize("topo,n,kw", [
    ("tree", 85, {"branching": 3}), ("grid", 60, {"cols": 7}),
    ("ring", 33, {}), ("line", 31, {}),
    ("circulant", 64, {"strides": [1, 5, 12]})])
def test_structured_sim_with_parts_matches_gather(topo, n, kw):
    # timing.structured_sim(parts=) builds the bundle itself; sync every
    # 3 rounds, ledger on and off, against the gather path
    nv = 40
    group = np.random.default_rng(n).integers(0, 3, (2, n))
    parts = pbc.Partitions.from_numpy([1, 4], [7, 11], group)
    inject = pbc.make_inject(n, nv)
    gather = pbc.BroadcastSim(_nbrs(topo, n, kw), n_values=nv, sync_every=3,
                              parts=parts, device="cpu")
    gs, gr = gather.run_fused(inject)
    for srv in (False, True):
        sim = ptiming.structured_sim(topo, n, nv, sync_every=3, parts=parts,
                                     srv_ledger=srv, device="cpu", **kw)
        assert sim._faulted is not None and sim.build_fixed(gr) is None
        ps, pr = sim.run_fused(inject)
        assert pr == gr and ps.t == gs.t and int(ps.msgs) == int(gs.msgs)
        np.testing.assert_array_equal(sim.received_node_major(ps),
                                      gather.received_node_major(gs))
        if srv:
            assert sim.server_msgs(ps) == gather.server_msgs(gs)


def test_faulted_guards():
    n = 16
    nbrs = _nbrs("tree", n, {})
    ex = pst.make_exchange("tree", n)
    group = np.zeros((1, n), np.int8)
    parts = pbc.Partitions.from_numpy([1], [3], group)
    # the reference's refusals, word for word
    for mod, exch, fault, dev in (
            (jbc, jst.make_exchange("tree", n),
             jst.make_faulted("tree", n, np.zeros((2, n), np.int8)),
             {"mesh": None}),
            (pbc, ex, pst.make_faulted("tree", n, np.zeros((2, n), np.int8)),
             {"device": "cpu"})):
        jp = (jbc.Partitions(jnp.array([1], jnp.int32),
                             jnp.array([3], jnp.int32), jnp.asarray(group))
              if mod is jbc else parts)
        with pytest.raises(ValueError, match="masked closures") as e1:
            mod.BroadcastSim(nbrs, n_values=4, exchange=exch, parts=jp,
                             **dev)
        with pytest.raises(ValueError, match="do not match") as e2:
            mod.BroadcastSim(nbrs, n_values=4, exchange=exch, parts=jp,
                             faulted=fault, **dev)
        if mod is jbc:
            want = (str(e1.value), str(e2.value))
        else:
            assert (str(e1.value), str(e2.value)) == want
    # a bundle without windows is the plain run
    sim = pbc.BroadcastSim(nbrs, n_values=4, exchange=ex, device="cpu",
                           faulted=pst.make_faulted("tree", n, group))
    assert sim._faulted is None and sim.build_fixed(2) is not None
    # n_shards adds the halo closures, as in the reference (16 nodes on
    # 2 shards: a halo form), to the delay bundles too
    halo = pst.make_faulted("tree", n, group, n_shards=2)
    want = jst.make_faulted("tree", n, group, n_shards=2)
    assert (halo.sharded_exchange is None) == (want.sharded_exchange is None)
    assert halo.sharded_exchange is not None
    assert pst.make_faulted("tree", n, group, n_shards=5).sharded_exchange \
        is None
    assert pst.make_edge_delayed("tree", n, np.ones((2, n), np.int32),
                                 n_shards=2).sharded_exchange is not None
    assert pst.make_faulted("random", n, group) is None
