"""Port parity for per-hop latency on the words-major structured path:
the bridges (``gather_delays_for``, ``gather_delays_from_rows``), the
delay bundles (``make_delayed``, ``make_delayed_faulted``,
``make_edge_delayed``, ``make_edge_delayed_faulted``) and
``BroadcastSim(delayed= | edge_delayed=)`` of gossip_glomers_tpu_torch
against the JAX reference on the CPU, on every structured topology (the
85-node tree's last level ragged), and against the port's own gather
ring on the same graph through the bridges.

Delays, groups and bitsets come from seeded numpy and go to both
packages; round counts, bitsets, the ring and the ledgers compare exactly
(tolerance 0).  The JAX sims are built with ``mesh=None``.
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

# (topology, n, kw, two per-direction delay cases: uniform, asymmetric)
CASES = [("tree", 64, {}, [(2, 2), (1, 3)]),
         ("tree", 85, {"branching": 4}, [(3, 3), (3, 1)]),
         ("grid", 64, {}, [(2, 2, 2, 2), (1, 2, 3, 1)]),
         ("ring", 32, {}, [(2, 2), (3, 1)]),
         ("line", 32, {}, [(2, 2), (1, 2)]),
         ("circulant", 64, {"strides": [1, 5, 21]},
          [(2,) * 6, (1, 2, 3, 1, 2, 3)])]
IDS = [f"{t}{n}" for t, n, _, _ in CASES]


def _nbrs(topo: str, n: int, kw: dict) -> np.ndarray:
    if topo == "circulant":
        return jtop.circulant(n, kw["strides"])
    if topo == "tree":
        return jtop.to_padded_neighbors(jtop.tree(n, kw.get("branching", 4)))
    build = {"grid": jtop.grid, "ring": jtop.ring, "line": jtop.line}[topo]
    return jtop.to_padded_neighbors(build(n))


def _n_rows(topo: str, n: int, kw: dict) -> int:
    return 2 if topo == "tree" else pst.fault_dir_senders(topo, n,
                                                          **kw).shape[0]


def _groups(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, (2, n)).astype(np.int8)


def _parts(groups: np.ndarray):
    """(JAX, port) Partitions: windows [2, 9) and [6, 14)."""
    starts, ends = [2, 6], [9, 14]
    return (jbc.Partitions(jnp.array(starts, jnp.int32),
                           jnp.array(ends, jnp.int32), jnp.asarray(groups)),
            pbc.Partitions.from_numpy(starts, ends, groups))


def _check(jsim, js, jr, psim, ps, pr, gsim=None, gs=None, gr=None) -> None:
    """The port's structured run equals the reference's (rounds, bitsets,
    ledgers, the (L, W, N) ring) and, given, the port's gather run."""
    assert pr == jr
    np.testing.assert_array_equal(psim.received_node_major(ps),
                                  jsim.received_node_major(js))
    assert int(ps.msgs) == int(js.msgs)
    assert (ps.srv_msgs is None) == (js.srv_msgs is None)
    if ps.srv_msgs is not None:
        assert int(ps.srv_msgs) == int(js.srv_msgs)
    np.testing.assert_array_equal(
        ps.history.numpy().view(np.uint32), np.asarray(js.history))
    if gsim is not None:
        assert gr == pr
        np.testing.assert_array_equal(gsim.received_node_major(gs),
                                      psim.received_node_major(ps))
        assert int(gs.msgs) == int(ps.msgs)
        if ps.srv_msgs is not None:
            assert int(gs.srv_msgs) == int(ps.srv_msgs)


@pytest.mark.parametrize("topo,n,kw,cases", CASES, ids=IDS)
def test_gather_bridges_match_reference(topo, n, kw, cases):
    nbrs = _nbrs(topo, n, kw)
    for dd in cases:
        np.testing.assert_array_equal(
            pst.gather_delays_for(topo, n, dd, nbrs, **kw),
            jst.gather_delays_for(topo, n, dd, nbrs, **kw))
    rows = np.random.default_rng(n).choice(
        [1, 2, 3], (_n_rows(topo, n, kw), n)).astype(np.int32)
    np.testing.assert_array_equal(
        pst.gather_delays_from_rows(topo, n, rows, nbrs, **kw),
        jst.gather_delays_from_rows(topo, n, rows, nbrs, **kw))
    with pytest.raises(ValueError):
        pst.gather_delays_for(topo, n, cases[0] + (1,), nbrs, **kw)
    with pytest.raises(ValueError):
        pst.gather_delays_from_rows(topo, n, rows[:, :-1], nbrs, **kw)


def test_gather_bridges_refuse_aliased_edges():
    # stride 32 of 64 nodes: its +s and -s classes are one physical edge
    n, kw = 64, {"strides": [1, 32]}
    nbrs = jtop.circulant(n, kw["strides"])
    with pytest.raises(ValueError, match="alias"):
        pst.gather_delays_for("circulant", n, (1, 1, 1, 2), nbrs, **kw)
    with pytest.raises(ValueError, match="alias"):
        jst.gather_delays_for("circulant", n, (1, 1, 1, 2), nbrs, **kw)
    rows = np.ones((4, n), np.int32)
    rows[3, 7] = 3
    with pytest.raises(ValueError, match="alias"):
        pst.gather_delays_from_rows("circulant", n, rows, nbrs, **kw)
    # equal delays on the aliased classes are one edge of one delay
    pst.gather_delays_for("circulant", n, (1, 1, 2, 2), nbrs, **kw)


@pytest.mark.parametrize("topo,n,kw,cases", CASES, ids=IDS)
def test_delayed_exchange_matches_reference(topo, n, kw, cases):
    # the bundles' delivery from one random ring, at every round of the
    # ring's first lap (a class whose send round is below 0 delivers
    # nothing) and after it
    rng = np.random.default_rng(3 * n)
    rows = rng.choice([1, 2, 3], (_n_rows(topo, n, kw), n)).astype(np.int32)
    for dd in cases:
        jb, pb = (jst.make_delayed(topo, n, dd, **kw),
                  pst.make_delayed(topo, n, dd, **kw))
        je, pe = (jst.make_edge_delayed(topo, n, rows, **kw),
                  pst.make_edge_delayed(topo, n, rows, **kw))
        assert pb.ring == jb.ring == max(dd) and pb.dir_delays == jb.dir_delays
        assert pe.delay_set == je.delay_set and pe.ring == je.ring
        hist = rng.integers(0, 1 << 32, (3, 2, n),
                            dtype=np.uint64).astype(np.uint32)
        ph = torch.from_numpy(hist.view(np.int32))
        class_rows = pe.class_rows("cpu")
        for t in range(5):
            np.testing.assert_array_equal(
                pb.exchange(ph[:pb.ring].contiguous(), t).numpy().view(
                    np.uint32),
                np.asarray(jb.exchange(jnp.asarray(hist[:jb.ring]), t)))
            np.testing.assert_array_equal(
                pe.exchange(ph, t, class_rows).numpy().view(np.uint32),
                np.asarray(je.exchange(jnp.asarray(hist), t,
                                       jnp.asarray(rows))))
        # the reference's composition: _take_delayed's zeros and slots
        for t in (0, 1, 4):
            np.testing.assert_array_equal(
                pst._take_delayed(ph, t, 2, 3).numpy().view(np.uint32),
                np.asarray(jst._take_delayed(jnp.asarray(hist), t, 2, 3)))


@pytest.mark.parametrize("topo,n,kw,cases", CASES, ids=IDS)
def test_delayed_sim_matches_reference_and_gather(topo, n, kw, cases):
    nbrs = _nbrs(topo, n, kw)
    nv = min(n, 48)
    inject = pbc.make_inject(n, nv)
    for dd in cases:
        ref = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=6,
                               exchange=jst.make_exchange(topo, n, **kw),
                               sync_diff=jst.make_sync_diff(topo, n, **kw),
                               delayed=jst.make_delayed(topo, n, dd, **kw))
        js, jr = ref.run(inject)
        sim = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=6,
                               exchange=pst.make_exchange(topo, n, **kw),
                               sync_diff=pst.make_sync_diff(topo, n, **kw),
                               delayed=pst.make_delayed(topo, n, dd, **kw),
                               device="cpu")
        ps, pr = sim.run(inject)
        gsim = pbc.BroadcastSim(
            nbrs, n_values=nv, sync_every=6, device="cpu",
            delays=pst.gather_delays_for(topo, n, dd, nbrs, **kw))
        gs, gr = gsim.run(inject)
        _check(ref, js, jr, sim, ps, pr, gsim, gs, gr)
        # the delay modes never take the fused flood loop
        assert sim.build_fixed(pr) is None
        fixed = sim.run_staged_fixed(sim.init_state(inject), pr)
        assert torch.equal(fixed.received, ps.received)
        assert torch.equal(fixed.history, ps.history)


@pytest.mark.parametrize("topo,n,kw,cases", CASES, ids=IDS)
def test_delayed_faulted_matches_reference_and_gather(topo, n, kw, cases):
    nbrs = _nbrs(topo, n, kw)
    nv = min(n, 48)
    inject = pbc.make_inject(n, nv)
    groups = _groups(n, 7 * n)
    jparts, pparts = _parts(groups)
    dd = cases[1]
    ref = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6, parts=jparts,
        exchange=jst.make_exchange(topo, n, **kw),
        delayed=jst.make_delayed_faulted(topo, n, dd, groups, **kw))
    js, jr = ref.run(inject)
    sim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6, parts=pparts,
        exchange=pst.make_exchange(topo, n, **kw),
        delayed=pst.make_delayed_faulted(topo, n, dd, groups, **kw),
        device="cpu")
    ps, pr = sim.run(inject)
    gsim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6, parts=pparts, device="cpu",
        delays=pst.gather_delays_for(topo, n, dd, nbrs, **kw))
    gs, gr = gsim.run(inject)
    _check(ref, js, jr, sim, ps, pr, gsim, gs, gr)


@pytest.mark.parametrize("topo,n,kw,cases", CASES, ids=IDS)
def test_edge_delayed_matches_reference_and_gather(topo, n, kw, cases):
    nbrs = _nbrs(topo, n, kw)
    nv = min(n, 48)
    inject = pbc.make_inject(n, nv)
    d = _n_rows(topo, n, kw)
    rows = np.random.default_rng(17 + n).choice(
        [1, 2, 3], (d, n)).astype(np.int32)
    ref = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6,
        exchange=jst.make_exchange(topo, n, **kw),
        sync_diff=jst.make_sync_diff(topo, n, **kw),
        edge_delayed=jst.make_edge_delayed(topo, n, rows, **kw))
    js, jr = ref.run(inject)
    sim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6,
        exchange=pst.make_exchange(topo, n, **kw),
        sync_diff=pst.make_sync_diff(topo, n, **kw),
        edge_delayed=pst.make_edge_delayed(topo, n, rows, **kw),
        device="cpu")
    ps, pr = sim.run(inject)
    gsim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6, device="cpu",
        delays=pst.gather_delays_from_rows(topo, n, rows, nbrs, **kw))
    gs, gr = gsim.run(inject)
    _check(ref, js, jr, sim, ps, pr, gsim, gs, gr)
    # constant rows reproduce make_delayed, launch for launch
    const = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6,
        exchange=pst.make_exchange(topo, n, **kw),
        edge_delayed=pst.make_edge_delayed(
            topo, n, np.full((d, n), 2, np.int32), **kw), device="cpu")
    per_dir = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6,
        exchange=pst.make_exchange(topo, n, **kw),
        delayed=pst.make_delayed(topo, n, (2,) * d, **kw), device="cpu")
    (a, ra), (b, rb) = const.run(inject), per_dir.run(inject)
    assert ra == rb and int(a.msgs) == int(b.msgs)
    assert torch.equal(a.received, b.received)
    assert torch.equal(a.history, b.history)


@pytest.mark.parametrize("topo,n,kw,cases", CASES, ids=IDS)
def test_edge_delayed_faulted_matches_reference_and_gather(topo, n, kw,
                                                           cases):
    nbrs = _nbrs(topo, n, kw)
    nv = min(n, 48)
    inject = pbc.make_inject(n, nv)
    groups = _groups(n, 11 * n)
    jparts, pparts = _parts(groups)
    rows = np.random.default_rng(19 + n).choice(
        [1, 3], (_n_rows(topo, n, kw), n), p=[0.7, 0.3]).astype(np.int32)
    ref = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6, parts=jparts,
        exchange=jst.make_exchange(topo, n, **kw),
        edge_delayed=jst.make_edge_delayed_faulted(topo, n, rows, groups,
                                                   **kw))
    js, jr = ref.run(inject)
    bundle = pst.make_edge_delayed_faulted(topo, n, rows, groups, **kw)
    ref_bundle = jst.make_edge_delayed_faulted(topo, n, rows, groups, **kw)
    np.testing.assert_array_equal(bundle.del_same,
                                  np.asarray(ref_bundle.del_same))
    sim = pbc.BroadcastSim(nbrs, n_values=nv, sync_every=6, parts=pparts,
                           exchange=pst.make_exchange(topo, n, **kw),
                           edge_delayed=bundle, device="cpu")
    ps, pr = sim.run(inject)
    gsim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=6, parts=pparts, device="cpu",
        delays=pst.gather_delays_from_rows(topo, n, rows, nbrs, **kw))
    gs, gr = gsim.run(inject)
    _check(ref, js, jr, sim, ps, pr, gsim, gs, gr)


def test_delay_bundle_errors():
    n, nv = 64, 16
    nbrs = jtop.to_padded_neighbors(jtop.grid(n))
    ex = pst.make_exchange("grid", n)
    delayed = pst.make_delayed("grid", n, (1, 2, 1, 2))
    groups = _groups(n, 1)
    _, parts = _parts(groups)
    with pytest.raises(ValueError, match="takes 4 direction delays"):
        pst.make_delayed("grid", n, (1, 2))
    with pytest.raises(ValueError, match="rounds >= 1"):
        pst.make_delayed("ring", n, (0, 1))
    with pytest.raises(ValueError, match="delay rows"):
        pst.make_edge_delayed("tree", n, np.ones((3, n), np.int32))
    with pytest.raises(ValueError, match="rounds >= 1"):
        pst.make_edge_delayed("line", n, np.zeros((2, n), np.int32))
    assert pst.make_delayed("random", n, (1,)) is None
    # n_shards: the halo closures where the halo gates pass
    assert (pst.make_delayed("grid", n, (1, 1, 1, 1), n_shards=4)
            .sharded_exchange is not None) \
        == pst.has_sharded_exchange("grid", n, 4)
    assert (pst.make_edge_delayed("line", n, np.ones((2, n), np.int32),
                                  n_shards=4).sharded_exchange is not None) \
        == pst.has_sharded_exchange("line", n, 4)
    with pytest.raises(ValueError, match="needs a structured exchange"):
        pbc.BroadcastSim(nbrs, n_values=nv, delayed=delayed, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        pbc.BroadcastSim(nbrs, n_values=nv, exchange=ex, delayed=delayed,
                         delays=np.ones(nbrs.shape, np.int32), device="cpu")
    with pytest.raises(ValueError, match="FaultedDelayed bundle"):
        pbc.BroadcastSim(nbrs, n_values=nv, exchange=ex, delayed=delayed,
                         parts=parts, device="cpu")
    with pytest.raises(ValueError, match="needs a partition schedule"):
        pbc.BroadcastSim(nbrs, n_values=nv, exchange=ex, device="cpu",
                         delayed=pst.make_delayed_faulted(
                             "grid", n, (1, 2, 1, 2), groups))
    with pytest.raises(ValueError, match="mutually exclusive"):
        pbc.BroadcastSim(nbrs, n_values=nv, exchange=ex, device="cpu",
                         edge_delayed=pst.make_edge_delayed(
                             "grid", n, np.ones((4, n), np.int32)),
                         faulted=pst.make_faulted("grid", n, groups),
                         parts=parts)
    with pytest.raises(ValueError, match="FaultedEdgeDelays"):
        pbc.BroadcastSim(nbrs, n_values=nv, exchange=ex, device="cpu",
                         parts=parts, edge_delayed=pst.make_edge_delayed(
                             "grid", n, np.ones((4, n), np.int32)))
    with pytest.raises(ValueError, match="per-edge delays need the gather"):
        pbc.BroadcastSim(nbrs, n_values=nv, exchange=ex, device="cpu",
                         delays=np.ones(nbrs.shape, np.int32))


def test_class_rows_pack_each_present_pair():
    # the tree's (2, N) rows at child positions: one packed mask a (d, v)
    # pair that has a receiver, none for an absent pair
    n = 85
    rows = np.ones((2, n), np.int32)
    rows[1, 10:20] = 3
    ed = pst.make_edge_delayed("tree", n, rows)
    assert ed.classes == ((0, 1), (1, 1), (1, 3))
    got = kernels.unpack_bits(ed.class_rows("cpu"), n).numpy()
    np.testing.assert_array_equal(got, np.stack([rows[0] == 1, rows[1] == 1,
                                                 rows[1] == 3]))
