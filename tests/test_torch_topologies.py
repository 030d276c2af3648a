"""Port parity for the shift topologies (grid, ring, line, circulant) and
the topology builders: gossip_glomers_tpu_torch against the JAX
reference on the CPU.

Inputs come from ``np.random.default_rng(seed)`` as uint32 and go to both
packages; bitsets compare bit for bit and integers exactly (tolerance 0).
The sizes cover the edge cases of each topology: a ring of 1, 2 or 3
nodes, a line of 1, a grid with ``cols > n``, ``cols = 1`` and a ragged
last row, and the circulant at n = 8 with degree 8, whose last stride is
n/2 (its +s and -s rotations meet the same node).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu.tpu_sim import timing as jtiming
from gossip_glomers_tpu_torch.parallel import topology as ptop
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst
from gossip_glomers_tpu_torch.tpu_sim import timing as ptiming

NS = (1, 2, 3, 4, 7, 8, 25, 4099)


def _payload(w: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (w, n), dtype=np.uint64).astype(
        np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _configs(n: int):
    """(topology, kw) pairs at n nodes, edge cases included."""
    out = [("grid", {}), ("grid", {"cols": 1}), ("grid", {"cols": 3}),
           ("grid", {"cols": n + 2}), ("ring", {}), ("line", {}),
           ("circulant", {"strides": jtop.expander_strides(n, 8, seed=0)}),
           ("circulant", {"strides": [1, 3, 2 * n + 5]})]
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("w", (1, 3))
def test_shift_exchanges_and_sync_diffs_match_reference(w, n):
    x = _payload(w, n, seed=100 * w + n)
    xj, xt = jnp.asarray(x), _torch(x)
    for topo, kw in _configs(n):
        tag = f"{topo} {kw} w={w} n={n}"
        want = np.asarray(jax.jit(jst.make_exchange(topo, n, **kw))(xj))
        # the exchange object (the direction table's plain version on
        # CPU tensors) and the reference-shaped plain function
        ex = pst.make_exchange(topo, n, **kw)
        assert isinstance(ex, pst.ShiftExchange)
        np.testing.assert_array_equal(_bits(ex(xt)), want, err_msg=tag)
        if topo == "grid":
            cols = kw.get("cols") or jtop.grid_cols(n)
            plain = pst.grid_exchange(xt, cols)
            np.testing.assert_array_equal(
                _bits(pst.grid_terms(xt, xt, xt, xt, cols)),
                np.asarray(jst.grid_terms(xj, xj, xj, xj, cols)))
        elif topo == "line":
            plain = pst.line_exchange(xt)
            np.testing.assert_array_equal(
                _bits(pst.line_terms(xt, xt)),
                np.asarray(jst.line_terms(xj, xj)))
        elif topo == "ring":
            plain = pst.ring_exchange(xt)
        else:
            plain = pst.circulant_exchange(xt, kw["strides"])
        np.testing.assert_array_equal(_bits(plain), want, err_msg=tag)
        assert int(pst.make_sync_diff(topo, n, **kw)(xt)) \
            == int(jax.jit(jst.make_sync_diff(topo, n, **kw))(xj)), tag


@pytest.mark.parametrize("n", (5, 64, 4099))
def test_per_direction_terms_match_reference(n):
    # grid_terms / line_terms take a different payload per direction
    ps = [_payload(2, n, seed=n + d) for d in range(4)]
    pj = [jnp.asarray(p) for p in ps]
    pt = [_torch(p) for p in ps]
    for cols in (1, 4, jtop.grid_cols(n)):
        np.testing.assert_array_equal(
            _bits(pst.grid_terms(*pt, cols)),
            np.asarray(jst.grid_terms(*pj, cols)))
    np.testing.assert_array_equal(_bits(pst.line_terms(pt[0], pt[1])),
                                  np.asarray(jst.line_terms(pj[0], pj[1])))
    np.testing.assert_array_equal(
        _bits(pst.circulant_exchange(pt[0], [])),
        np.asarray(jst.circulant_exchange(pj[0], [])))


@pytest.mark.parametrize("n", (1, 2, 3, 7, 8, 9, 16, 25, 100))
def test_sync_diff_mask_argument_matches_reference(n):
    term = _payload(3, n, seed=n)
    recv = _payload(3, n, seed=n + 1)
    mask = np.random.default_rng(n).integers(0, 2, n).astype(bool)
    assert int(pst._dir_diff(_torch(term), _torch(recv),
                             torch.from_numpy(mask))) \
        == int(jst._dir_diff(jnp.asarray(term), jnp.asarray(recv),
                             jnp.asarray(mask)))
    assert int(pst._dir_diff(_torch(term), _torch(recv))) \
        == int(jst._dir_diff(jnp.asarray(term), jnp.asarray(recv)))


@pytest.mark.parametrize("n", (1, 2, 3, 8, 64, 4099))
def test_flood_round_objects_match_one_reference_flood_step(n):
    rec = _payload(2, n, seed=n)
    fr = _payload(2, n, seed=n + 1)
    for topo, kw in _configs(n):
        jex = jst.make_exchange(topo, n, **kw)
        new = np.asarray(jex(jnp.asarray(fr))) & ~rec
        ex = pst.make_exchange(topo, n, **kw)
        rec_t, fr_t = _torch(rec), _torch(fr)
        nxt = torch.empty_like(fr_t)
        assert ex.flood_round(rec_t, fr_t, nxt) is nxt
        np.testing.assert_array_equal(_bits(rec_t), rec | new)
        np.testing.assert_array_equal(_bits(nxt), new)
        np.testing.assert_array_equal(_bits(fr_t), fr)    # untouched


@pytest.mark.parametrize("n", (1, 2, 3, 5, 8, 25, 100, 341))
def test_builder_copies_match_reference(n):
    assert ptop.grid_cols(n) == jtop.grid_cols(n)
    for cols in (None, 1, 3, n + 2):
        assert ptop.grid(n, cols) == jtop.grid(n, cols)
    assert ptop.ring(n) == jtop.ring(n)
    assert ptop.line(n) == jtop.line(n)
    for degree in (2, 4, 8, 16):
        for seed in (0, 1):
            strides = ptop.expander_strides(n, degree, seed)
            assert strides == jtop.expander_strides(n, degree, seed)
            got = ptop.circulant(n, strides)
            want = jtop.circulant(n, strides)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for degree in (1, 3, 8):
        for seed in (0, 5):
            got = ptop.random_regular(n, degree, seed)
            want = jtop.random_regular(n, degree, seed)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for adj in (ptop.grid(n), ptop.ring(n), ptop.line(n)):
        np.testing.assert_array_equal(ptop.to_padded_neighbors(adj),
                                      jtop.to_padded_neighbors(adj))


def test_shift_dirs_at_the_half_stride():
    # n = 8, degree 8: strides [1, 2, 3, 4]; stride 4 sends +4 and -4 to
    # one node, which the exchange ORs once and the ledger degree counts
    # twice (circulant(8, strides) lists it twice), as in the reference
    strides = ptop.expander_strides(8, 8, seed=0)
    assert strides == [1, 2, 3, 4]
    dirs = pst.shift_dirs("circulant", 8, strides=strides)
    assert dirs.offs == (7, 1, 6, 2, 5, 3, 4, 4)
    assert dirs.flags == (kernels.WRAP,) * 8
    assert (ptop.circulant(8, strides) >= 0).sum(axis=1).tolist() == [8] * 8
    with pytest.raises(ValueError, match="shift topology"):
        pst.shift_dirs("tree", 8)
    assert pst.make_exchange("full", 8) is None
    assert pst.make_sync_diff("full", 8) is None


def test_discover_rounds_matches_reference():
    for n in (1, 2, 3, 4, 5, 7, 8, 16, 25, 26, 100, 4099):
        strides = jtop.expander_strides(n, 8, seed=0)
        cases = [("ring", {}), ("line", {}), ("grid", {}),
                 ("grid", {"cols": 1}), ("grid", {"cols": 3}),
                 ("grid", {"cols": n + 2}),
                 ("circulant", {"strides": strides})]
        for topo, kw in cases:
            for nv in (1, 3, 32, 96):
                assert ptiming.discover_rounds(topo, n, nv, **kw) \
                    == jtiming.discover_rounds(topo, n, nv, **kw), \
                    (topo, kw, n, nv)
    with pytest.raises(ValueError, match="connect"):
        ptiming.discover_rounds("circulant", 8, 4, strides=[2])
    with pytest.raises(ValueError):
        ptiming.discover_rounds("full", 8, 4)


def test_words_axis_entries_match_reference():
    for n in (64, 4099):
        assert ptiming.words_axis_entries(n, 4096) \
            == jtiming.words_axis_entries(n, 4096)
    res = {name: {"wall_s": 1.0, "rounds": 3, "_state": None}
           for name in ("tree", "circulant")}
    assert ptiming.format_words_regime(res, 4096) \
        == jtiming.format_words_regime(res, 4096)


@pytest.mark.parametrize("topology", ["grid", "ring", "line", "circulant"])
def test_nbrs_for_matches_reference(topology):
    for n in (1, 2, 5, 64):
        kw = ({"strides": jtop.expander_strides(n, 8, seed=0)}
              if topology == "circulant" else {})
        np.testing.assert_array_equal(
            ptiming._nbrs_for(topology, n, **kw),
            jtiming._nbrs_for(topology, n, **kw))
