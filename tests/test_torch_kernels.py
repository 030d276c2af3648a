"""The tree-flood kernel wrappers of gossip_glomers_tpu_torch.

On CPU tensors each wrapper takes its plain PyTorch version; those are
held against the JAX reference (``structured.tree_exchange``,
``lax.population_count(...).sum(0)``, one ``_flood_loop`` round).  The
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.  Every comparison is exact (tolerance 0): the
values are bitsets and counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.tpu_sim import kernels


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("w,n", [(1, 1), (1, 5), (3, 64), (8, 4097),
                                 (32, 100)])
def test_cpu_wrappers_match_plain_and_reference(w, n):
    x = _u32((w, n), seed=w * 7919 + n)
    xt, xj = _torch(x), jnp.asarray(x)
    before = dict(kernels.LAUNCHES)

    inbox = kernels.tree_exchange(xt)
    assert torch.equal(inbox, kernels.tree_exchange_plain(xt))
    np.testing.assert_array_equal(_bits(inbox),
                                  np.asarray(jst.tree_exchange(xj)))

    pc = kernels.col_popcount(xt)
    assert pc.dtype == torch.int32 and pc.shape == (n,)
    assert torch.equal(pc, kernels.col_popcount_plain(xt))
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(lax.population_count(xj).sum(axis=0)))
    np.testing.assert_array_equal(
        kernels.popcount(xt).numpy(), np.asarray(lax.population_count(xj)))

    # CPU calls take the plain versions and launch nothing
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("w,n", [(1, 1), (1, 64), (3, 257), (8, 4097)])
def test_flood_round_matches_one_reference_flood_step(w, n):
    rec = _u32((w, n), seed=n)
    fr = _u32((w, n), seed=n + 1)
    loop = jbc._flood_loop(lambda p: jst.tree_exchange(p, 4), 1)
    want_rec, want_fr = loop(jnp.asarray(rec), jnp.asarray(fr))

    rec_t, fr_t = _torch(rec), _torch(fr)
    nxt = torch.empty_like(fr_t)
    out = kernels.tree_flood_round(rec_t, fr_t, nxt)
    assert out is nxt
    np.testing.assert_array_equal(_bits(rec_t), np.asarray(want_rec))
    np.testing.assert_array_equal(_bits(nxt), np.asarray(want_fr))
    np.testing.assert_array_equal(_bits(fr_t), fr)        # input untouched


def test_flood_round_rejects_aliased_buffers():
    rec = _torch(_u32((2, 16), seed=3))
    fr = _torch(_u32((2, 16), seed=4))
    with pytest.raises(ValueError, match="aliases frontier"):
        kernels.tree_flood_round(rec, fr, fr)
    with pytest.raises(ValueError, match="aliases frontier"):
        kernels.tree_flood_round(rec, fr, fr.view(-1).view(2, 16))
    with pytest.raises(ValueError, match="received"):
        kernels.tree_flood_round(rec, fr, rec)


def test_wrappers_check_dtype_shape_and_device():
    x = torch.zeros(2, 8, dtype=torch.int64)
    with pytest.raises(TypeError):
        kernels.tree_exchange(x)
    with pytest.raises(ValueError):
        kernels.col_popcount(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.tree_exchange(torch.zeros(8, 2, dtype=torch.int32).T)
    # neither CPU nor CUDA: no plain fallback, no kernel
    with pytest.raises(ValueError, match="device"):
        kernels.col_popcount(torch.zeros(2, 8, dtype=torch.int32,
                                         device="meta"))
