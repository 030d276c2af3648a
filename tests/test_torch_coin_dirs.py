"""The words-major coins' direction descriptors and the four-nodes-a-thread
tree exchange, held on the CPU.

- ``structured.coin_dirs`` gives each direction row's sender and receiver
  ids as closed forms of the receiver column; ``kernels.coin_dir_rows``
  materializes them.  At every position where the edge exists they equal
  the JAX reference's id rows, clipped as ``make_nemesis`` clips them
  (``nemesis_dir_pairs`` for the delivery contract, ``fault_dir_senders``
  and the receiver column for the degree contract), for all five
  topologies, the tree at branchings 1, 2, 3, 4 and 32, and node counts
  that are no multiple of 32 or of 4.
- ``kernels.wm_fault_coins`` through the descriptors equals
  ``wm_fault_coins_plain`` over the reference's id rows in every stream
  (loss, dup, the ledger mode), for live bits inside ``exists``.
- A numpy emulation of tree_flood.cu's exchange — the four-nodes-a-thread
  path for k = 4 where n % 4 == 0 (each 16-byte vector load guarded by
  its first word, a load past the row an error), the scalar kernel
  elsewhere — equals ``tree_exchange_plain`` and the JAX exchange.

Inputs come from seeded numpy; every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst

# n: no multiple of 32 or of 4 besides multiples (and 1, 2: every edge a
# pad or the root's)
TREE_CASES = [("tree", n, {"branching": k}) for k in (1, 2, 3, 4, 32)
              for n in (1, 2, 67, 85, 130, 160)]
SHIFT_CASES = [("grid", 60, {}), ("grid", 67, {"cols": 7}),
               ("grid", 130, {"cols": 16}), ("ring", 1, {}), ("ring", 2, {}),
               ("ring", 33, {}), ("line", 1, {}), ("line", 2, {}),
               ("line", 67, {}),
               ("circulant", 64, {"strides": [1, 5, 31]}),
               ("circulant", 67, {"strides": jtop.expander_strides(67, 6,
                                                                   1)})]
CASES = TREE_CASES + SHIFT_CASES
IDS = [f"{t}{n}" + (f"k{kw['branching']}" if t == "tree" else "")
       + (f"c{kw['cols']}" if "cols" in kw else "")
       for t, n, kw in CASES]
# chip_smoke.py's WM_STREAMS: (loss, dup, srv)
WM_STREAMS = ((False, False, False), (True, False, False),
              (False, True, False), (True, True, False),
              (False, False, True), (True, False, True))
COINS = dict(t=5, seed=0xC0FFEE, loss_num=int(0.3 * 2**32),
             dup_num=int(0.2 * 2**32))


def _reference_ids(topo, n, kw, degree):
    """The reference's (src, dst, exists) id rows of one contract, the
    ids clipped into [0, n) as make_nemesis clips them."""
    if degree:
        src = jst.fault_dir_senders(topo, n, **kw)
        dst = np.where(src >= 0, np.arange(n)[None, :], -1)
    else:
        src, dst, _ = jst.nemesis_dir_pairs(topo, n, **kw)
    return np.clip(src, 0, n - 1), np.clip(dst, 0, n - 1), src >= 0


@pytest.mark.parametrize("degree", (False, True), ids=("del", "deg"))
@pytest.mark.parametrize("topo,n,kw", CASES, ids=IDS)
def test_coin_dir_rows_match_reference_ids(topo, n, kw, degree):
    dirs = pst.coin_dirs(topo, n, degree=degree, **kw)
    src, dst, exists = _reference_ids(topo, n, kw, degree)
    assert dirs.dtype == np.int64 and dirs.shape == (src.shape[0], 4)
    got_src, got_dst = kernels.coin_dir_rows(torch.from_numpy(dirs), n)
    assert got_src.dtype == got_dst.dtype == torch.int32
    assert got_src.shape == got_dst.shape == src.shape
    np.testing.assert_array_equal(got_src.numpy()[exists], src[exists])
    np.testing.assert_array_equal(got_dst.numpy()[exists], dst[exists])


@pytest.mark.parametrize("topo,n,kw", CASES, ids=IDS)
def test_nemesis_arrays_carry_coin_dirs(topo, n, kw):
    spec = pf.NemesisSpec(n_nodes=n, seed=3, loss_rate=0.1, loss_until=5)
    arrs = pst.make_nemesis(topo, n, spec, device="cpu", **kw).arrs
    for dirs, want in ((arrs.coin_dirs, pst.coin_dirs(topo, n, **kw)),
                       (arrs.deg_coin_dirs,
                        pst.coin_dirs(topo, n, degree=True, **kw))):
        assert dirs.dtype == torch.int64
        np.testing.assert_array_equal(dirs.numpy(), want)
    assert arrs.to("cpu").coin_dirs.shape == arrs.coin_dirs.shape


@pytest.mark.parametrize("degree", (False, True), ids=("del", "deg"))
@pytest.mark.parametrize("topo,n,kw", CASES, ids=IDS)
def test_wm_fault_coins_through_descriptors(topo, n, kw, degree):
    src, dst, exists = _reference_ids(topo, n, kw, degree)
    rng = np.random.default_rng(n * 31 + len(src) + degree)
    live = kernels.pack_bits(torch.from_numpy(
        exists & (rng.random(exists.shape) < 0.8)))
    dirs = torch.from_numpy(pst.coin_dirs(topo, n, degree=degree, **kw))
    before = dict(kernels.LAUNCHES)
    for loss, dup, srv in WM_STREAMS:
        kw_c = dict(COINS, loss=loss, dup=dup, srv=srv)
        got = kernels.wm_fault_coins(dirs, n, live, **kw_c)
        want = kernels.wm_fault_coins_plain(
            torch.from_numpy(src.astype(np.int32)),
            torch.from_numpy(dst.astype(np.int32)), live, **kw_c)
        for g, x in zip(got, want):
            assert (g is None) == (x is None)
            assert x is None or torch.equal(g, x), (loss, dup, srv)
    assert kernels.LAUNCHES == before          # CPU calls launch nothing


def test_coin_descriptors_refuse_what_the_kernel_does_not_take():
    n = 8
    bad = [kernels.coin_id(kernels.COIN_SHIFT, n),       # offset >= n
           kernels.coin_id(kernels.COIN_PARENT, 0),      # k = 0
           kernels.coin_id(kernels.COIN_CHILD, 0, 1),
           kernels.coin_id(kernels.COIN_IDENT, 3),
           (7, 0)]                                       # no such form
    ident = kernels.coin_id(kernels.COIN_IDENT)
    for idf in bad:
        with pytest.raises(ValueError):
            kernels.coin_dir_rows(torch.tensor([idf + ident]), n)
    live = torch.zeros((1, 1), dtype=torch.int32)
    for dirs in (torch.zeros((1, 4), dtype=torch.int32),
                 torch.zeros((1, 3), dtype=torch.int64)):
        with pytest.raises(ValueError):
            kernels.wm_fault_coins(dirs, n, live, **COINS, loss=True,
                                   dup=False, srv=False)


# -- tree_flood.cu's exchange, emulated ---------------------------------


class _Row:
    """One payload row whose reads must stay inside [0, n)."""

    def __init__(self, row: np.ndarray):
        self.row = row

    def word(self, i: int) -> int:
        assert 0 <= i < len(self.row), f"read of word {i} past the row"
        return int(self.row[i])

    def vec(self, v: int) -> tuple:
        assert 4 * v + 3 < len(self.row), f"read of vector {v} past the row"
        return tuple(int(x) for x in self.row[4 * v: 4 * v + 4])


def _emulate_scalar(row: _Row, n: int, k: int) -> np.ndarray:
    out = np.zeros(n, np.uint32)
    for i in range(n):
        v = row.word((i - 1) // k) if i > 0 else 0
        for c in range(k * i + 1, min(k * i + k + 1, n)):
            v |= row.word(c)
        out[i] = v
    return out


def _emulate_quads(row: _Row, n: int) -> np.ndarray:
    """quads_inbox over one row: thread q writes words 4q..4q+3
    from the vectors at 16q .. 16q+12 and the word 16q+16 (each guarded
    by its first word) and the parent words q - 1 and q."""
    out = np.zeros(n, np.uint32)
    zero = (0, 0, 0, 0)
    for q in range(n // 4):
        c = 16 * q
        v = [row.vec(4 * q + j) if c + 4 * j < n else zero for j in range(4)]
        last = row.word(c + 16) if c + 16 < n else 0
        up, up0 = row.word(q), row.word(q - 1) if q > 0 else 0
        out[4 * q: 4 * q + 4] = (
            up0 | v[0][1] | v[0][2] | v[0][3] | v[1][0],
            up | v[1][1] | v[1][2] | v[1][3] | v[2][0],
            up | v[2][1] | v[2][2] | v[2][3] | v[3][0],
            up | v[3][1] | v[3][2] | v[3][3] | last)
    return out


def emulate_tree_exchange(x: np.ndarray, k: int) -> np.ndarray:
    """gg_tree_exchange's dispatch on 16-byte aligned buffers: the quads
    for k = 4 where n % 4 == 0, the scalar kernel elsewhere."""
    w, n = x.shape
    plan = _emulate_quads if k == 4 and n % 4 == 0 else \
        (lambda row, n: _emulate_scalar(row, n, k))
    return np.stack([plan(_Row(x[r]), n) for r in range(w)])


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("k", (3, 4))
@pytest.mark.parametrize("rem", (0, 1, 2, 3))
@pytest.mark.parametrize("w", (1, 3))
def test_tree_quad_plan_matches_plain(w, rem, k):
    # every n % 16 of its residue mod 4 up to 68 nodes, so that each of
    # the last quad's guards (vectors 1-3, the word 16q + 16) both takes
    # and skips its load, and one row of 260 + rem nodes; the JAX
    # exchange at the largest n (the plain one is held to it elsewhere)
    ns = [n for n in range(1, 69) if n % 4 == rem] + [256 + 4 + rem]
    for n in ns:
        x = _u32((w, n), seed=n * 13 + w + k)
        got = emulate_tree_exchange(x, k)
        want = kernels.tree_exchange_plain(
            torch.from_numpy(x.view(np.int32)), k).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"n = {n}")
    np.testing.assert_array_equal(
        got, np.asarray(jst.tree_exchange(jnp.asarray(x), k)))


# -- chip_smoke.py's integer-operation count of the coins ---------------


def test_coin_ops_count_the_function():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ops = dict(zip((kernels.COIN_IDENT, kernels.COIN_SHIFT,
                    kernels.COIN_PARENT, kernels.COIN_CHILD), (0, 3, 2, 1)))
    assert {f: smoke.OPS_ID[f] for f in ops} == ops
    assert (smoke.OPS_LOSS_COIN, smoke.OPS_DUP_COIN) == (13, 10)
    n, n_loss, n_dup = 130, 7, 5
    # the 4-ary tree's 2 delivery rows: PARENT and IDENT ids, then the
    # bit and the AND, 4 a slot; its degree rows the same parent row and
    # 4 CHILD rows at 3 a slot
    for degree, per_node in ((False, 2 * 4), (True, 4 + 4 * 3)):
        dirs = torch.from_numpy(pst.coin_dirs("tree", n, degree=degree))
        assert smoke.coin_ops(dirs, n, n_loss, n_dup) == \
            per_node * n + 13 * n_loss + 10 * n_dup
    # the circulant's degree rows: a SHIFT sender and an IDENT receiver
    dirs = torch.from_numpy(pst.coin_dirs("circulant", 64, degree=True,
                                          strides=[1, 5, 31]))
    assert len(dirs) == 6
    assert smoke.coin_ops(dirs, 64, 0, 0) == 6 * 5 * 64
