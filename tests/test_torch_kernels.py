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
from gossip_glomers_tpu_torch.tpu_sim import structured as pst


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

    # a copy: rec_t is updated in place, and jnp.asarray may alias rec's
    # buffer for a computation that is still running
    rec_t, fr_t = _torch(rec.copy()), _torch(fr)
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


@pytest.mark.parametrize("w,n", [(1, 1), (1, 5), (3, 64), (8, 4097)])
def test_node_major_col_popcount_matches_reference(w, n):
    x = _u32((n, w), seed=w + 3 * n)
    before = dict(kernels.LAUNCHES)
    pc = kernels.col_popcount(_torch(x), node_major=True)
    assert pc.dtype == torch.int32 and pc.shape == (n,)
    assert torch.equal(pc, kernels.col_popcount_plain(_torch(x), True))
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(lax.population_count(jnp.asarray(x)).sum(
            axis=1)))
    assert kernels.LAUNCHES == before


def _shift_cases(n):
    strides = [1, 3, 7]
    return [("grid", {"cols": 5}), ("ring", {}), ("line", {}),
            ("circulant", {"strides": strides})]


@pytest.mark.parametrize("w,n", [(1, 1), (1, 2), (2, 23), (3, 4099)])
def test_shift_kernel_plain_versions_match_reference(w, n):
    from gossip_glomers_tpu_torch.tpu_sim import structured as pst

    rec, fr = _u32((w, n), seed=n), _u32((w, n), seed=n + 1)
    for topo, kw in _shift_cases(n):
        dirs = pst.shift_dirs(topo, n, **kw)
        want = np.asarray(jst.make_exchange(topo, n, **kw)(jnp.asarray(fr)))
        got = kernels.shift_exchange(_torch(fr), dirs)
        assert torch.equal(got, kernels.shift_exchange_plain(_torch(fr),
                                                             dirs))
        np.testing.assert_array_equal(_bits(got), want)
        rec_t, nxt = _torch(rec.copy()), torch.empty_like(_torch(fr))
        kernels.shift_flood_round(rec_t, _torch(fr), nxt, dirs)
        np.testing.assert_array_equal(_bits(rec_t), rec | (want & ~rec))
        np.testing.assert_array_equal(_bits(nxt), want & ~rec)


def test_shift_flood_round_rejects_aliased_buffers():
    from gossip_glomers_tpu_torch.tpu_sim import structured as pst

    dirs = pst.shift_dirs("ring", 16)
    rec = _torch(_u32((2, 16), seed=3))
    fr = _torch(_u32((2, 16), seed=4))
    with pytest.raises(ValueError, match="aliases frontier"):
        kernels.shift_flood_round(rec, fr, fr, dirs)
    with pytest.raises(ValueError, match="received"):
        kernels.shift_flood_round(rec, fr, rec, dirs)


@pytest.mark.parametrize("w", (1, 4))
def test_gather_plain_versions_match_reference(w):
    n, d = 257, 6
    rng = np.random.default_rng(w)
    nbrs = rng.integers(-1, n, (n, d)).astype(np.int32)   # -1 pads
    live = rng.integers(0, 2, (n, d)).astype(bool)
    payload, recv = _u32((n, w), seed=5), _u32((n, w), seed=6)
    nt = torch.from_numpy(nbrs)
    before = dict(kernels.LAUNCHES)
    for lv in (None, live, live | (nbrs < 0)):
        lj = jnp.asarray(nbrs >= 0 if lv is None else lv)
        lt = None if lv is None else torch.from_numpy(lv)
        want = np.asarray(jbc._gather_or(jnp.asarray(payload),
                                         jnp.asarray(nbrs), lj))
        got = kernels.gather_or(_torch(payload), nt, lt)
        assert torch.equal(got, kernels.gather_or_plain(_torch(payload), nt,
                                                        lt))
        np.testing.assert_array_equal(_bits(got), want)
        want_d = int(jbc._sync_diff_pc(jnp.asarray(payload),
                                       jnp.asarray(recv), jnp.asarray(nbrs),
                                       lj))
        got_d = kernels.sync_diff_pc(_torch(payload), _torch(recv), nt, lt)
        assert got_d.dtype == torch.int64 and got_d.shape == ()
        assert int(got_d) == want_d
    assert kernels.LAUNCHES == before


def test_gather_wrappers_check_their_operands():
    payload = torch.zeros(8, 2, dtype=torch.int32)
    nbrs = torch.zeros(8, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="nbrs"):
        kernels.gather_or(payload, nbrs.long())
    with pytest.raises(ValueError, match="live"):
        kernels.gather_or(payload, nbrs, torch.ones(8, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="live"):
        kernels.gather_or(payload, nbrs, torch.ones(8, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="recv"):
        kernels.sync_diff_pc(payload, torch.zeros(8, 3, dtype=torch.int32),
                             nbrs)
    with pytest.raises(ValueError, match="device"):
        kernels.gather_or(payload.to("meta"), nbrs.to("meta"))


def _tree_masked_warp_emulation(x, live_p, live_k, k):
    """tree_flood.cu's masked inbox, emulated in numpy as its threads
    compute it: node i = 32m + lane takes its parent bit from word m of
    the parent row, and (k <= 31) its k kids bits from the k + 1 words
    km .. km + k of the kids row that lanes 0..k load, at bit k*lane + 1
    of them, by a funnel shift of the two words there; a wider k loads
    each child's word.  Payload loads stay inside [0, n)."""
    w, n = x.shape
    nw = (n + 31) // 32
    u64 = np.uint64
    i = np.arange(n, dtype=np.int64)
    m, lane = i >> 5, (i & 31).astype(u64)
    pw, kw = live_p.astype(u64), live_k.astype(u64)
    parent = (pw[m] >> lane) & u64(1)
    out = np.where(((i > 0) & (parent == 1))[None, :],
                   x[:, np.maximum(i - 1, 0) // k], 0).astype(x.dtype)
    if k <= 31:
        lanes = np.arange(32)[None, :]
        at = k * m[:, None] + lanes                 # lane l's word
        words = np.where((lanes <= k) & (at < nw),
                         kw[np.minimum(at, nw - 1)], u64(0))
        off = k * (i & 31) + 1
        lo = words[np.arange(n), off >> 5]
        hi = words[np.arange(n), (off >> 5) + 1]
        kids = (((hi << u64(32)) | lo) >> (off & 31).astype(u64)) \
            & u64(0xFFFFFFFF)
    for j in range(k):
        c = k * i + 1 + j
        cc = np.minimum(c, n - 1)
        bit = ((kids >> u64(j)) & u64(1) if k <= 31
               else (kw[cc >> 5] >> (cc & 31).astype(u64)) & u64(1))
        out |= np.where(((c < n) & (bit == 1))[None, :], x[:, cc], 0
                        ).astype(x.dtype)
    return out


@pytest.mark.parametrize("k", (1, 2, 3, 4, 31, 32))
@pytest.mark.parametrize("w,n", [(1, 1), (2, 5), (1, 33), (3, 4097),
                                 (1, 4127), (2, 4129)])
def test_tree_masked_warp_bits_match_plain_and_reference(w, n, k):
    # n = 4127 and 4129 are 31 and 1 mod 32: the last warp's kids words
    # run past the row; the words' bits past n are random
    x = _u32((w, n), seed=n * 31 + k)
    nw = kernels.packed_words(n)
    rows = _u32((2, nw), seed=n * 37 + k)
    rp, rk = _torch(rows[0]), _torch(rows[1])
    got = _tree_masked_warp_emulation(x, rows[0], rows[1], k)
    want = kernels.tree_masked_exchange_plain(_torch(x), rp, rk, k)
    np.testing.assert_array_equal(got, _bits(want))
    # one row for both edges: the reference's tree_masked_exchange
    same = _tree_masked_warp_emulation(x, rows[0], rows[0], k)
    lv = kernels.unpack_bits(rp, n).numpy()[None, :]
    np.testing.assert_array_equal(
        same, np.asarray(jst.tree_masked_exchange(jnp.asarray(x),
                                                  jnp.asarray(lv), k)))


# -- the ring modes ------------------------------------------------------


def _ring_case(seed: int, slots: int, w: int, n: int, rows: int):
    """(ring (slots, W, N), packed rows (rows, ceil(N/32))) from ``seed``;
    the rows' bits past N random too."""
    return (_torch(_u32((slots, w, n), seed)),
            _torch(_u32((rows, kernels.packed_words(n)), seed + 1)))


def _ones_row(n: int) -> torch.Tensor:
    return kernels.pack_bits(torch.ones(n, dtype=torch.bool))


def _tree_composition(ring, table, live, k):
    """The tree ring inbox as |V| masked exchanges ORed: each entry one
    tree_masked_exchange_plain of its slot, the other term's row zero."""
    n = ring.shape[2]
    zero = torch.zeros(kernels.packed_words(n), dtype=torch.int32)
    out = torch.zeros(ring.shape[1:], dtype=torch.int32)
    for slot, kind, row in table:
        gate = _ones_row(n) if row < 0 else live[row]
        parent, kids = ((gate, zero) if kind == kernels.TREE_PARENT
                        else (zero, gate))
        out |= kernels.tree_masked_exchange_plain(ring[slot], parent, kids, k)
    return out


def _shift_composition(ring, dirs, live):
    """The shift ring inbox as one exchange a row, ORed: the masked
    exchange of its slot over the row's one direction (the unmasked one
    without rows)."""
    out = torch.zeros(ring.shape[1:], dtype=torch.int32)
    for d, slot in enumerate(dirs.slots):
        one = kernels.ShiftDirs((dirs.offs[d],), (dirs.flags[d],), dirs.cols)
        out |= (kernels.shift_exchange_plain(ring[slot], one) if live is None
                else kernels.shift_masked_exchange_plain(
                    ring[slot], live[d:d + 1].contiguous(), one))
    return out


@pytest.mark.parametrize("n", [1, 5, 33, 100, 4097])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_tree_ring_twin_matches_masked_composition(n, k):
    rng = np.random.default_rng(n * 31 + k)
    ring, live = _ring_case(n + k, 3, 2, n, 6)
    before = dict(kernels.LAUNCHES)
    # random slots, kinds and rows (-1: ungated); 21 entries run as two
    # launches on the card
    table = [(int(rng.integers(0, 3)), int(rng.integers(0, 2)),
              int(rng.integers(-1, 6))) for _ in range(21)]
    for tab in (table[:2], table[:5], table):
        assert torch.equal(kernels.tree_ring_exchange(ring, tab, live, k),
                           _tree_composition(ring, tab, live, k))
    # ungated, no live tensor at all
    bare = [(s, kind, -1) for s, kind, _ in table[:4]]
    assert torch.equal(kernels.tree_ring_exchange(ring, bare, None, k),
                       _tree_composition(ring, bare, live, k))
    # entries dropped on the host (send round below 0) deliver what their
    # slots would as zeros
    kept = [e for e in table if e[0] != 1]
    zeroed = ring.clone()
    zeroed[1] = 0
    assert torch.equal(kernels.tree_ring_exchange(ring, kept, live, k),
                       kernels.tree_ring_exchange(zeroed, table, live, k))
    empty = kernels.tree_ring_exchange(ring, [], None, k)
    assert empty.shape == (2, n) and not empty.any()
    assert kernels.LAUNCHES == before


def _tree_ring_quads_emulation(ring, table, live):
    """tree_flood.cu's ring_quads (k = 4, N % 4 == 0), modelled in torch
    as its threads compute it: thread q ORs over the entries, for a
    from-parent entry, parent words q - 1 (node 4q; none at q = 0) and q
    under the receivers' bits 4q .. 4q+3, four bits of row word q // 8;
    for a from-kids entry (only where a child lies below N), the 16-byte
    child vectors at words 16q, 16q+4, 16q+8, 16q+12 and the word 16q+16,
    each loaded only where it starts below N, under the children's bits
    16q+1 .. 16q+16, taken from row words q // 2 and q // 2 + 1 by one
    funnel shift of 16 (q % 2) + 1.  Every load's index is held inside
    its row."""
    _, w, n = ring.shape
    assert n % 4 == 0
    nw = kernels.packed_words(n)
    q = torch.arange(n // 4)
    c = 16 * q
    x64 = ring.to(torch.int64) & kernels.MASK32
    lv = None if live is None else live.to(torch.int64) & kernels.MASK32
    out = torch.zeros((w, n // 4, 4), dtype=torch.int64)

    def gate(words, bits, j):
        return torch.where((bits >> j) & 1 == 1, words, 0)

    for slot, kind, row in table:
        x = x64[slot]
        if kind == kernels.TREE_PARENT:
            assert int((q >> 3).max()) < nw
            bits = (torch.full_like(q, 0xF) if row < 0
                    else (lv[row][q >> 3] >> (4 * (q & 7))) & 0xF)
            up = x[:, q]
            up0 = torch.where(q > 0, x[:, (q - 1).clamp(min=0)], 0)
            for i, word in enumerate((up0, up, up, up)):
                out[:, :, i] |= gate(word, bits, i)
            continue
        has = c + 1 < n
        if row < 0:
            bits = torch.full_like(q, 0xFFFF)
        else:
            m = q >> 1
            assert not has.any() or int(m[has].max()) < nw
            lo = lv[row][m.clamp(max=nw - 1)]
            hi = torch.where(m + 1 < nw, lv[row][(m + 1).clamp(max=nw - 1)],
                             0)
            bits = (((hi << 32) | lo) >> (16 * (q & 1) + 1)) & kernels.MASK32
        words = torch.zeros((w, n // 4, 17), dtype=torch.int64)
        for v in range(4):                   # the 16-byte vectors
            start = c + 4 * v
            ok = start < n
            assert not ok.any() or int((start[ok] + 3).max()) < n
            idx = (start[:, None] + torch.arange(4)).clamp(max=n - 1)
            words[:, :, 4 * v:4 * v + 4] = torch.where(ok[:, None], x[:, idx],
                                                        0)
        words[:, :, 16] = torch.where(c + 16 < n, x[:, (c + 16).clamp(
            max=n - 1)], 0)
        for j in range(16):                  # child 16q + 1 + j
            out[:, :, j // 4] |= torch.where(has, gate(words[:, :, 1 + j],
                                                       bits, j), 0)
    v = out.reshape(w, n)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _jax_tree_terms(hist, table, rows, k):
    """The reference's tree deliveries (structured.py _delayed_impl's
    from-parent and from-kids terms, masked as its delayed modes mask
    them), one a table entry, ORed."""
    out = None
    for slot, kind, row in table:
        p = jnp.asarray(hist[slot])
        if kind == kernels.TREE_PARENT:
            term = jst.tree_from_parent(p, k)
            if row >= 0:
                term = jst._mask_cols(term, jnp.asarray(rows[row]))
        else:
            if row >= 0:
                p = jst._mask_cols(p, jnp.asarray(rows[row]))
            term = jst.tree_from_kids(p, k)
        out = term if out is None else out | term
    return np.asarray(out)


@pytest.mark.parametrize("n", [4, 8, 12, 16, 20, 4096, 65540])
def test_tree_ring_quads_match_plain_and_reference(n):
    # the four-nodes-a-thread ring kernel's arithmetic, n < 16 included
    # (no quad has all its children), on random tables of 1-3 slots
    # (rows -1: ungated) and on make_edge_delayed's table at round 5; the
    # rows' bits past N random
    rng = np.random.default_rng(n)
    hist = _u32((3, 2, n), n)
    ring = _torch(hist)
    live = _torch(_u32((6, kernels.packed_words(n)), n + 1))
    rows = kernels.unpack_bits(live, n).numpy()
    for slots in (1, 2, 3):
        table = [(int(rng.integers(0, slots)), int(rng.integers(0, 2)),
                  int(rng.integers(-1, 6))) for _ in range(3 * slots)]
        got = _tree_ring_quads_emulation(ring, table, live)
        assert torch.equal(got, kernels.tree_ring_exchange_plain(
            ring, table, live, 4)), table
        np.testing.assert_array_equal(_bits(got), _jax_tree_terms(
            hist, table, rows, 4))
    delays = rng.choice([1, 3], (2, n)).astype(np.int32)
    pe = pst.make_edge_delayed("tree", n, delays)
    je = jst.make_edge_delayed("tree", n, delays)
    table = [(pst.send_slot(5, v, pe.ring), d, j)
             for j, (d, v) in enumerate(pe.classes)]
    h = hist[:pe.ring]
    got = _tree_ring_quads_emulation(_torch(h), table, pe.class_rows("cpu"))
    np.testing.assert_array_equal(_bits(got), np.asarray(je.exchange(
        jnp.asarray(h), 5, jnp.asarray(delays))))


@pytest.mark.parametrize("n", [5, 64, 257, 4097])
@pytest.mark.parametrize("mode", ["circulant", "ring", "line", "grid"])
def test_shift_ring_twin_matches_masked_composition(mode, n):
    rng = np.random.default_rng(n + len(mode))
    kw = {"circulant": {"strides": [1, 2, 7] if n > 14 else [1]},
          "grid": {"cols": max(1, int(np.sqrt(n)) - 1)}}.get(mode, {})
    dirs = pst.shift_dirs(mode, n, **kw)
    before = dict(kernels.LAUNCHES)
    for reps in (1, 3):       # 18 circulant rows: one launch
        rows = len(dirs.offs) * reps
        ring, live = _ring_case(n + reps, 3, 3, n, rows)
        table = kernels.ShiftDirs(
            dirs.offs * reps, dirs.flags * reps, dirs.cols,
            tuple(int(s) for s in rng.integers(0, 3, rows)))
        for lv in (None, live):
            assert torch.equal(kernels.shift_ring_exchange(ring, table, lv),
                               _shift_composition(ring, table, lv))
        # rows dropped on the host deliver what their slots would as
        # zeros
        keep = [d for d in range(rows) if table.slots[d] != 2]
        kept = kernels.ShiftDirs(tuple(table.offs[d] for d in keep),
                                 tuple(table.flags[d] for d in keep),
                                 table.cols,
                                 tuple(table.slots[d] for d in keep))
        zeroed = ring.clone()
        zeroed[2] = 0
        assert torch.equal(
            kernels.shift_ring_exchange(ring, kept, live[keep].contiguous()),
            kernels.shift_ring_exchange(zeroed, table, live))
    none = kernels.shift_ring_exchange(
        ring, kernels.ShiftDirs((), (), dirs.cols, ()))
    assert none.shape == (3, n) and not none.any()
    assert kernels.LAUNCHES == before


def test_ring_plan_keys_windows_by_slot():
    # a window belongs to one ring slot: directions within a tile of each
    # other merge only within a slot; the plan stages a group (a slot's
    # windows and directions) at a time, and ends with the groups, the
    # liveness slot's words and each direction's row
    n = 1 << 20
    dirs = pst.shift_dirs("ring", n)
    one = kernels.shift_windows(dirs, n, 2048)
    assert len(one) == 1 and one[0].slot == 0
    table = kernels.ShiftDirs(dirs.offs * 2, dirs.flags * 2, dirs.cols,
                              (2, 0, 1, 0))
    wins = kernels.shift_windows(table, n, 2048)
    assert [(w.slot, w.dirs) for w in wins] == [(0, (1, 3)), (1, (2,)),
                                               (2, (0,))]
    assert kernels.shift_groups(table, n) == ((1, 3), (2,), (0,))
    words, count = kernels._shift_plan(table, n, False, live=True)
    words = list(words)
    tile, n_win, n_dirs, live_at = words[0], words[5], words[6], words[7]
    tail = words[8 + 4 * n_win + 3 * n_dirs:]
    assert count == 8 + 4 * n_win + 3 * n_dirs + 2 + 6 * 3 + n_dirs
    slot = kernels.live_slot_words(tile)
    # (slot, first window, windows, first direction, directions, liveness
    # offset): each group's windows from the stage's start, its slices
    # right after them
    at = [words[8 + 4 * k + 3] for k in range(n_win)]
    assert at == [0, 0, 0]
    assert tail[:2] == [3, slot] and tail[2:20] == [
        0, 0, 1, 0, 2, live_at, 1, 1, 1, 2, 1, live_at,
        2, 2, 1, 3, 1, live_at]
    assert tail[20:] == [1, 3, 2, 0]
    assert words[2] == live_at + 2 * slot          # the largest group's
    # more than MAX_DIRS rows of one slot split into groups
    big = kernels.ShiftDirs(dirs.offs * 9, dirs.flags * 9, dirs.cols,
                            (0,) * 18)
    assert [len(g) for g in kernels.shift_groups(big, n)] == [16, 2]
    # the one-source plan keeps its layout, and its wrappers refuse a ring
    # table
    assert kernels._shift_plan(dirs, n, False)[1] == 8 + 4 + 3 * 2
    with pytest.raises(ValueError, match="shift_ring_exchange"):
        kernels._one_source(table)


def test_ring_wrappers_check_their_operands():
    ring, live = _ring_case(1, 2, 1, 40, 4)
    with pytest.raises(ValueError, match="slot"):
        kernels.tree_ring_exchange(ring, [(2, 0, -1)], live)
    with pytest.raises(ValueError, match="kind"):
        kernels.tree_ring_exchange(ring, [(0, 2, -1)], live)
    with pytest.raises(ValueError, match="row"):
        kernels.tree_ring_exchange(ring, [(0, 0, 4)], live)
    with pytest.raises(ValueError, match="packed"):
        kernels.tree_ring_exchange(ring, [(0, 0, 0)], live[:, :1])
    with pytest.raises(ValueError, match=r"\(L, W, N\)"):
        kernels.tree_ring_exchange(ring[0], [(0, 0, -1)])
    dirs = pst.shift_dirs("line", 40)
    with pytest.raises(ValueError, match="slot"):
        kernels.shift_ring_exchange(ring, dirs)
    with pytest.raises(ValueError, match="slot"):
        kernels.shift_ring_exchange(ring, kernels.ShiftDirs(
            dirs.offs, dirs.flags, 0, (0, 5)))
    with pytest.raises(ValueError, match="packed"):
        kernels.shift_ring_exchange(ring, kernels.ShiftDirs(
            dirs.offs, dirs.flags, 0, (0, 1)), live)
