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


# -- the Kafka round's plain versions against the reference's XLA code ----


def _kafka_words(shape, c, seed, density=0.15):
    """uint32 presence words of ``shape + (Wc,)`` with slots below ``c``
    set at ``density``."""
    rng = np.random.default_rng(seed)
    wc = (c + 31) // 32
    bits = rng.random((*shape, wc * 32)) < density
    bits[..., c:] = False
    return (bits.reshape(*shape, wc, 32)
            * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(
        -1).astype(np.uint32)


def _jax_top_off(words):
    # kafka.py _round :641-647
    base = (jnp.arange(words.shape[-1], dtype=jnp.int32) * 32)
    return jnp.max(jnp.where(words > 0, base + 32
                             - lax.clz(words).astype(jnp.int32), 0), axis=-1)


def _jax_or_rows(x):
    return lax.reduce(x, jnp.uint32(0), lax.bitwise_or, (0,))


KAFKA_PLAIN_SHAPES = [(1, 1, 1), (3, 7, 33), (31, 5, 128), (16, 40, 64)]


@pytest.mark.parametrize("n,k,c", KAFKA_PLAIN_SHAPES)
def test_top_off_and_or_rows_match_reference(n, k, c):
    w = _kafka_words((n, k), c, n + c, density=0.05)
    w[0, 0, -1] = 0xFFFFFFFF                       # the top bit
    np.testing.assert_array_equal(kernels.top_off(_torch(w)).numpy(),
                                  np.asarray(_jax_top_off(jnp.asarray(w))))
    np.testing.assert_array_equal(_bits(kernels.or_rows(_torch(w))),
                                  np.asarray(_jax_or_rows(jnp.asarray(w))))


@pytest.mark.parametrize("n,k,c", KAFKA_PLAIN_SHAPES)
def test_kafka_merge_plain_matches_reference(n, k, c):
    # the wipe (:438-442), present | deliver and the HWM (:516-659), the
    # push origin record and the resync unions (:666, :695-710)
    rng = np.random.default_rng(3 * n + k)
    present, origin = _kafka_words((n, k), c, 1), _kafka_words((n, k), c, 2)
    row = _kafka_words((k,), c, 3, 0.05)
    carry, own = (_kafka_words((n, k), c, s, 0.05) for s in (4, 5))
    lc = rng.integers(0, c + 1, (n, k)).astype(np.int32)
    wipe, live = rng.random(n) < 0.3, rng.random(n) < 0.6
    for deliver in ((), ("row",), ("carry",), ("carry", "own")):
        parts = {"row": row[None], "carry": carry, "own": own}
        d = np.zeros((1, k, present.shape[-1]), np.uint32)
        for name in deliver:
            d = d | parts[name]
        jp = jnp.where(jnp.asarray(wipe)[:, None, None], jnp.uint32(0),
                       jnp.asarray(present)) | jnp.asarray(d)
        jl = jnp.maximum(jnp.where(jnp.asarray(wipe)[:, None], 0,
                                   jnp.asarray(lc)),
                         _jax_top_off(jnp.asarray(d)))
        lv = jnp.asarray(live)[:, None, None]
        pull = _jax_or_rows(jnp.where(lv, jp, jnp.uint32(0)))
        push = _jax_or_rows(jnp.where(lv, jnp.asarray(origin),
                                      jnp.uint32(0)))
        anyo = jnp.any(jnp.asarray(origin) > 0, axis=(1, 2))
        for resync in (kernels.RESYNC_NONE, kernels.RESYNC_PULL,
                       kernels.RESYNC_PUSH):
            pt, lt = _torch(present), torch.from_numpy(lc.copy())
            kw = {name: _torch(parts[name][0] if name == "row"
                               else parts[name]) for name in deliver}
            union, got_any = kernels.kafka_merge(
                pt, lt, wipe=torch.from_numpy(wipe), resync=resync,
                live=torch.from_numpy(live), origin=_torch(origin), **kw)
            np.testing.assert_array_equal(_bits(pt), np.asarray(jp))
            np.testing.assert_array_equal(lt.numpy(), np.asarray(jl))
            if resync == kernels.RESYNC_NONE:
                assert union is None and got_any is None
                continue
            want = pull if resync == kernels.RESYNC_PULL else push
            np.testing.assert_array_equal(_bits(union), np.asarray(want))
            if resync == kernels.RESYNC_PUSH:
                np.testing.assert_array_equal(got_any.numpy() != 0,
                                              np.asarray(anyo))


@pytest.mark.parametrize("n,k,c,s", [(1, 1, 1, 1), (5, 3, 33, 2),
                                     (24, 7, 128, 3), (40, 50, 64, 1)])
def test_kafka_nem_deliver_plain_matches_reference(n, k, c, s):
    # the materialized faulted origin union (:517-544) under a crash +
    # loss plan, over the whole axis and over slabs (the scan_blocks form)
    from gossip_glomers_tpu.tpu_sim import faults as jf

    rng = np.random.default_rng(n + s)
    wc = (c + 31) // 32
    m = n * s
    cell = np.resize(rng.permutation(k * c), m)
    ok = (rng.random(m) < 0.8) & (np.arange(m) < k * c)
    keys, slot = cell // c, cell % c
    bit = np.where(ok, np.uint32(1) << (slot % 32).astype(np.uint32),
                   0).astype(np.uint32)
    spec = jf.NemesisSpec(n_nodes=n, seed=7, crash=((0, 9, (0, n // 2)),),
                          loss_rate=0.4, loss_until=9)
    plan = spec.compile()
    for t in (3, 9):
        up = np.array(jf.node_up(plan, jnp.int32(t),
                                 jnp.arange(n, dtype=jnp.int32)))
        g_origin = jnp.repeat(jnp.arange(n, dtype=jnp.int32), s)
        ids = jnp.arange(n, dtype=jnp.int32)
        recv = ((jnp.asarray(up)[:, None]
                 & ~jf.edge_drop(plan, jnp.int32(t), g_origin[None, :],
                                 ids[:, None]))
                | (g_origin[None, :] == ids[:, None]))
        want = jnp.zeros((n, k, wc), jnp.uint32).at[
            :, jnp.asarray(np.where(ok, keys, k)),
            jnp.asarray(slot // 32)].add(
            jnp.where(recv, jnp.asarray(bit)[None, :], jnp.uint32(0)),
            mode="drop")
        widx = torch.from_numpy(np.where(ok, keys * wc + slot // 32,
                                         -1).astype(np.int32))
        loss_num = int(plan.loss_num) if t < int(plan.loss_until) else 0
        for step in (n, 3):
            got = torch.full((n, k, wc), -1, dtype=torch.int32)
            for lo in range(0, n, step):
                kernels.kafka_nem_deliver(
                    got, widx, _torch(bit), torch.from_numpy(up), s_dim=s,
                    lo=lo, hi=min(n, lo + step), t=t, seed=int(plan.seed),
                    loss_num=loss_num)
            np.testing.assert_array_equal(_bits(got), np.asarray(want))


@pytest.mark.parametrize("n,k,c", KAFKA_PLAIN_SHAPES)
def test_kafka_commit_plain_matches_reference(n, k, c):
    # the resync take (:711-715), the classification and the per-key
    # winners (:746-774), the learned offsets (:776-780) and the commit
    # ledger terms (:809-818)
    rng = np.random.default_rng(5 * n + c)
    present = _kafka_words((n, k), c, 7)
    union = _kafka_words((k,), c, 8, 0.3)
    lc = rng.integers(0, c + 1, (n, k)).astype(np.int32)
    req = np.where(rng.random((n, k)) < 0.5,
                   rng.integers(-1, c + 3, (n, k)), -1).astype(np.int32)
    kv_sent = np.where(rng.random(k) < 0.3, 0,
                       rng.integers(1, c + 2, k)).astype(np.int32)
    take, up, reach = (rng.random(n) < p for p in (0.6, 0.8, 0.7))
    tally = rng.random(n) < 0.5
    # the reference's expressions
    jtake = jnp.asarray(take)[:, None, None]
    sync_new = jnp.where(jtake, jnp.asarray(union)[None]
                         & ~jnp.asarray(present), jnp.uint32(0))
    jp = jnp.asarray(present) | sync_new
    hwm = jnp.maximum(jnp.asarray(lc), _jax_top_off(sync_new))
    jreq, big = jnp.asarray(req), jnp.int32(n + 1)
    rows_col = jnp.arange(n, dtype=jnp.int32)[:, None]
    want = (jreq >= 1) & jnp.asarray(up)[:, None]
    skip = want & (hwm > 0) & (hwm >= jreq)
    dance = want & ~skip
    active = dance & jnp.asarray(reach)[:, None]
    blocked = dance & ~jnp.asarray(reach)[:, None]
    readv = jnp.asarray(kv_sent)[None, :]
    exists = readv > 0
    read_only = active & exists & (jreq <= readv)
    need_cas = active & exists & (jreq > readv)
    writers = active & ~exists
    cas_win = jnp.min(jnp.where(need_cas, rows_col, big), axis=0)
    wrt_last = jnp.max(jnp.where(writers, rows_col, -1), axis=0)
    cas_req = jnp.sum(jnp.where(need_cas & (rows_col == cas_win[None, :]),
                                jreq, 0), axis=0)
    wrt_req = jnp.sum(jnp.where(writers & (rows_col == wrt_last[None, :]),
                                jreq, 0), axis=0)
    kv_val = jnp.where(cas_win < big, cas_req,
                       jnp.where(wrt_last >= 0, wrt_req, readv[0]))
    learn = jnp.where(need_cas & (rows_col == cas_win[None, :]), jreq,
                      jnp.where(read_only, readv,
                                jnp.where(writers, jreq, 0)))
    msgs0, retries, mult = 4294967000, 7, 2
    msgs = (msgs0 + 2 * int(active.sum()) + 2 * int((need_cas
                                                      | writers).sum())
            + retries * int(blocked.sum()) + mult * int(tally.sum())) \
        & 0xFFFFFFFF
    # the port's plain versions through the CPU wrappers
    pt, lt = _torch(present), torch.from_numpy(lc.copy())
    t_req, t_up, t_reach = (torch.from_numpy(x) for x in (req, up, reach))
    t_sent = torch.from_numpy(kv_sent)
    cw, wl, counts = kernels.kafka_commit_select(
        pt, lt, take=torch.from_numpy(take), union=_torch(union), req=t_req,
        want_ok=t_up, reach=t_reach, kv_sent=t_sent,
        tally=torch.from_numpy(tally))
    np.testing.assert_array_equal(_bits(pt), np.asarray(jp))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(hwm))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(cas_win))
    np.testing.assert_array_equal(wl.numpy(), np.asarray(wrt_last))
    assert counts.tolist() == [int(active.sum()), int(blocked.sum()),
                               int((need_cas | writers).sum()),
                               int(tally.sum())]
    kv, m = kernels.kafka_commit_apply(
        lt, t_req, cw, wl, t_sent, t_reach, t_up, counts,
        torch.tensor(msgs0), kv_retries=retries, tally_mult=mult)
    np.testing.assert_array_equal(lt.numpy(),
                                  np.asarray(jnp.maximum(hwm, learn)))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(kv_val))
    assert int(m) == msgs


@pytest.mark.parametrize("m,k", [(1, 1), (17, 3), (200, 9), (64, 64)])
def test_kafka_alloc_matches_reference(m, k):
    # _rank_within_key (:119) and _alloc (:137): the (node, slot)
    # linearization, the KV gate and the capacity
    from gossip_glomers_tpu.tpu_sim import kafka as jk
    from gossip_glomers_tpu_torch.tpu_sim import kafka as pk

    rng = np.random.default_rng(m + k)
    s = 2 if m % 2 == 0 else 1
    rows = m // s
    send_key = rng.integers(-1, k, (rows, s)).astype(np.int32)
    kv_val = rng.integers(0, 6, k).astype(np.int32)
    reach, up = rng.random(rows) < 0.8, rng.random(rows) < 0.9
    got = pk._alloc(torch.from_numpy(kv_val), torch.from_numpy(send_key),
                    torch.from_numpy(reach), torch.from_numpy(up), k, 5)
    want = jk._alloc(jnp.asarray(kv_val), jnp.asarray(send_key),
                     jnp.asarray(reach), jnp.asarray(up),
                     lambda x: jnp.zeros_like(x), k, 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    valid = rng.random(m) < 0.7
    keys = rng.integers(0, k, m).astype(np.int32)
    np.testing.assert_array_equal(
        pk._rank_within_key(torch.from_numpy(keys),
                            torch.from_numpy(valid)).numpy(),
        np.asarray(jk._rank_within_key(jnp.asarray(keys),
                                       jnp.asarray(valid))))


def test_popcount_forms_agree():
    # the CPU's numpy form and the torch SWAR form (the card's) of the
    # popcount, on edge words and random ones
    x = torch.from_numpy(np.concatenate([
        np.array([0, -1, -2**31, 2**31 - 1, 1, 0x55555555, -0x55555556],
                 np.int32),
        np.random.default_rng(3).integers(-2**31, 2**31, 4096).astype(
            np.int32)]))
    want = np.array([bin(int(v) & 0xFFFFFFFF).count("1")
                     for v in x.numpy()], np.int32)
    assert (kernels.popcount(x).numpy() == want).all()
    assert (kernels.popcount_swar(x).numpy() == want).all()
    assert kernels.popcount(x).dtype == kernels.popcount_swar(x).dtype \
        == torch.int32


@pytest.mark.parametrize("node_major", (False, True))
@pytest.mark.parametrize("n,c", [(1, 1), (5, 3), (64, 24), (4097, 1),
                                 (513, 33)])
def test_and_fold_plain_matches_reference_reduce(n, c, node_major):
    # the traffic drivers' completion fold: the reference's
    # lax.reduce(..., bitwise_and) over the node axis (broadcast.py
    # _traffic_done, kafka.py _traffic_round), mostly-set words so that
    # the AND keeps bits
    x = _u32((n, c), seed=n * 31 + c) | _u32((1, c), seed=c)
    if not node_major:
        x = np.ascontiguousarray(x.T)
    want = lax.reduce(jnp.asarray(x), np.uint32(0xFFFFFFFF),
                      lax.bitwise_and, (0 if node_major else 1,))
    got = kernels.and_fold(_torch(x), node_major)
    np.testing.assert_array_equal(_bits(got), np.asarray(want))
    assert _bits(got).any()


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
# every (node_major, N, C) at which the card checks and_fold: the smoke's
# serving and ragged shapes, and the card tests' (tests/test_torch_cuda.py)
_CARD_FOLD = ([(False, n, w) for w, n in
               [(1, 1), (1, 5), (3, 4097), (1, 65539), (768, 1000),
                (256, 4099)]]
              + [(True, n, c) for n, c in
                 [(5, 1), (4097, 1), (1000, 3), (513, 33), (70000, 128),
                  (1000, 384), (3, 257), (64, 64 * 6), (1000, 3 * 2),
                  (7, 1)]])


@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("shape", sorted(set(_SMOKE.serving_fold_shapes()
                                             + _CARD_FOLD)))
def test_fold_probes_cover_every_block(shape, offset):
    # the card's and_fold input clears, in each line, a bit of the line's
    # own at its first and last four nodes, and every block of the
    # kernel's geometry holds a probe in some line: a kernel that skips a
    # block, a head or a tail disagrees with and_rows
    node_major, n, c = shape
    p = _SMOKE.fold_probes(shape, 7, offset)
    ranges = _SMOKE.fold_ranges(shape, offset)
    lines = len(ranges)
    assert lines == c
    by_line = [p[p[:, 0] == i] for i in range(lines)]
    for line, rows in enumerate(by_line):
        nodes, bits = rows[:, 1], rows[:, 2]
        assert len(set(bits.tolist())) == len(bits) \
            <= _SMOKE.FOLD_PROBE_BITS
        assert len(set(nodes.tolist())) == len(nodes)
        assert {0, n - 1} <= set(nodes.tolist())
        assert set(range(min(4, n))) | set(range(max(0, n - 4), n)) \
            <= set(nodes.tolist())
        # the ranges tile the line
        flat = [x for lo, hi in ranges[line] for x in (lo, hi)]
        assert flat[0] == 0 and flat[-1] == n and flat == sorted(flat)
    for k in range(max(len(r) for r in ranges)):
        assert any(k < len(r) and ((rows[:, 1] >= r[k][0])
                                   & (rows[:, 1] < r[k][1])).any()
                   for r, rows in zip(ranges, by_line)), (shape, k)


@pytest.mark.parametrize("shape", [(False, 4099, 3), (False, 65539, 1),
                                   (True, 1000, 3), (True, 513, 33),
                                   (True, 4097, 1)])
def test_fold_input_catches_skipped_ranges(shape):
    # a mutation check of the card's input: and_rows over the probe bitset
    # with one block left out (in every line, or in one line) or one head
    # / tail word left out differs from the whole fold
    node_major, n, c = shape
    for offset in (0, 1):
        x = _SMOKE.fold_input(shape, 5, "cpu", offset)
        lines = x.t() if node_major else x          # (C, N)
        whole = kernels.and_rows(lines.t())
        ranges = _SMOKE.fold_ranges(shape, offset)
        for k in range(max(len(r) for r in ranges)):
            cut = lines.clone()
            for line, r in enumerate(ranges):
                if k < len(r):
                    cut[line, r[k][0]:r[k][1]] = -1
            assert not torch.equal(kernels.and_rows(cut.t()), whole), k
        for node in (0, 1, 2, 3, n - 4, n - 3, n - 2, n - 1):
            cut = lines.clone()
            cut[c // 2, node] = -1
            assert not torch.equal(kernels.and_rows(cut.t()), whole), node
