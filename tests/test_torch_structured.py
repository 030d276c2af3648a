"""Port parity: the tree exchange, its halves, the tree sync diff and the
host helpers of gossip_glomers_tpu_torch against the JAX reference.

Inputs come from ``np.random.default_rng(seed)`` as uint32 and go to both
packages; bitsets compare bit for bit and integers exactly (tolerance 0).
The reference's ``tree_from_kids`` takes its roll fold at W = 8 and its
reshape fold at W = 1 and W = 32, so both lowerings are held.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu.tpu_sim import timing as jtiming
from gossip_glomers_tpu_torch.parallel import topology as ptop
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import timing as ptiming

NS = (1, 2, 5, 16, 25, 64, 100, 4097)
WS = (1, 8, 32)


def _payload(w: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (w, n), dtype=np.uint64).astype(
        np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("w", WS)
def test_tree_exchange_matches_reference(w, n):
    x = _payload(w, n, seed=1000 * w + n)
    xj, xt = jnp.asarray(x), _torch(x)
    for k in (2, 4):
        for jf, pf in ((jst.tree_from_parent, pst.tree_from_parent),
                       (jst.tree_from_kids, pst.tree_from_kids),
                       (jst.tree_exchange, pst.tree_exchange)):
            want = np.asarray(jf(xj, k))
            got = _bits(pf(xt, k))
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=(
                f"{pf.__name__} w={w} n={n} k={k}"))
        # the simulator's exchange closure on CPU tensors
        np.testing.assert_array_equal(
            _bits(pst.make_exchange("tree", n, branching=k)(xt)),
            np.asarray(jst.make_exchange("tree", n, branching=k)(xj)))
        want_diff = int(jst.tree_sync_diff(xj, k))
        assert int(pst.tree_sync_diff(xt, k)) == want_diff
        assert int(pst.make_sync_diff("tree", n, branching=k)(xt)) \
            == want_diff


def test_tree_exchange_single_node_is_zero():
    x = _torch(_payload(3, 1, seed=7))
    assert not pst.tree_exchange(x).any()
    assert int(pst.tree_sync_diff(x)) == 0


@pytest.mark.parametrize("topology", ["grid", "ring", "line", "circulant"])
def test_other_topologies_raise_naming_roadmap(topology):
    # every named topology has a structured exchange, and a partition
    # schedule runs on it through the masked closures that
    # timing.structured_sim builds (structured.make_faulted), with their
    # halo forms on a mesh, and the delay bundles' halo forms exist
    # exactly where the reference's do
    kw = {"strides": [1, 3]} if topology == "circulant" else {}
    group = np.zeros((1, 16), np.int8)
    parts = pbc.Partitions.from_numpy(np.array([1]), np.array([3]), group)
    sim = ptiming.structured_sim(topology, 16, 4, parts=parts, device="cpu",
                                 **kw)
    assert sim.words_major and sim._faulted is not None
    halo = pst.make_faulted(topology, 16, group, n_shards=2, **kw)
    assert (halo.sharded_exchange is None) == (
        pst.make_sharded_exchange(topology, 16, 2, **kw) is None)
    d = pst.fault_dir_senders(topology, 16, **kw).shape[0]
    rows = np.ones((d, 16), np.int32)
    assert (pst.make_edge_delayed(topology, 16, rows, n_shards=2,
                                  **kw).sharded_exchange is None) \
        == (jst.make_edge_delayed(topology, 16, rows, n_shards=2,
                                  **kw).sharded_exchange is None)
    assert pst.make_exchange(topology, 16, **kw) is not None
    assert pst.make_sync_diff(topology, 16, **kw) is not None
    assert ptiming.discover_rounds(topology, 16, 4, **kw) \
        == jtiming.discover_rounds(topology, 16, 4, **kw)


@pytest.mark.parametrize("n", (1, 2, 6, 7, 64, 341))
@pytest.mark.parametrize("k", (2, 4))
def test_topology_copies_match_reference(n, k):
    assert ptop.tree(n, k) == jtop.tree(n, k)
    got = ptop.to_padded_neighbors(ptop.tree(n, k))
    want = jtop.to_padded_neighbors(jtop.tree(n, k))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_values", (1, 31, 32, 33, 96, 200))
def test_make_inject_and_num_words_match_reference(n_values):
    assert pbc.num_words(n_values) == jbc.num_words(n_values)
    for n in (1, 5, 64):
        got = pbc.make_inject(n, n_values)
        want = jbc.make_inject(n, n_values)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    origins = np.random.default_rng(n_values).integers(0, 9, n_values)
    np.testing.assert_array_equal(pbc.make_inject(9, n_values, origins),
                                  jbc.make_inject(9, n_values, origins))


def test_discover_rounds_matches_reference():
    # includes the ragged n=6 tree of test_discover_rounds_tree_matches_bfs
    # (node 5 is the only depth-2 node)
    for n in (1, 2, 5, 6, 7, 21, 64, 86, 341, 4097):
        for k in (2, 4):
            for nv in (1, 3, 8, 96):
                assert ptiming.discover_rounds("tree", n, nv, branching=k) \
                    == jtiming.discover_rounds("tree", n, nv, branching=k), \
                    (n, k, nv)
