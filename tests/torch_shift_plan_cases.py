"""The shift kernels' staging plan, held on the CPU: the shared cases of
the ``tests/test_torch_shift_plan_*.py`` files.

Each ``test_torch_shift_plan_*.py`` file parametrizes some of the case
functions here (a case function is the body of one test, its name the
test's without ``test_``), so that no one file holds the whole suite's
slowest cases.  They hold ``kernels.shift_windows`` and the launch plan
``kernels._shift_plan``, also its masked form with liveness slices.

shift_flood.cu cuts a row into tiles and stages, per tile, one shared-
memory window for each run of nearby direction offsets.  Here, for every
mode chip_smoke.py's ``shift_modes`` names (circulant, ring, line, grid
with a ragged last row) at tiny, ragged and main-path n and two tile
caps:

- every direction's source range of every tile lies inside its window,
  each direction in exactly one window, and each window's slot in a
  stage holds it at any 16-byte phase without touching the next slot;
- a plain-torch emulation of the kernel — stage each tile's windows (and
  in the fused round its received words) into a stage buffer at the
  phase a bulk copy would give, then OR the directions out of it — equals
  ``shift_exchange_plain`` / ``shift_flood_round_plain`` and the JAX
  ``structured`` exchange on the same seeded inputs, with tolerance 0
  (bitsets);
- the masked plan (``live=True``) keeps the unmasked plan's tile and
  windows, and puts one slot a direction after them, each holding the
  tile's slice of its packed liveness row at any 16-byte phase and any
  tile start (also tiles that are no multiple of 32 nodes); its
  emulation — the slices staged beside the windows, each term ANDed with
  the bit it reads there — equals ``shift_masked_exchange_plain`` and the
  JAX masked exchange;
- a ring plan (a table with ``slots``) stages a (tile, group) unit at a
  time, a group a slot's rows (at most 16) with its windows and its
  rows' slices; its emulation — each unit staged from its slot at the
  phase a bulk copy gives, the groups ORed into one inbox — equals
  ``shift_ring_exchange_plain`` and the JAX delayed exchanges
  (``make_edge_delayed``, ``make_delayed``) reading 1-3 slots, and the
  delay phases' tables at 2^20 nodes keep the 2048-node tile.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.parallel import topology
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as pst

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

NS = (1, 5, 8, 4097, 65539, 1 << 20)
TILES = (kernels.SHIFT_TILE, 64)
# the masked plan also at a tile cap that is no multiple of 32, so that
# tiles start inside a packed liveness word
LIVE_TILES = TILES + (1000,)
MODES = ("circulant", "ring", "line", "grid")
SENTINEL = -0x5A5A5A5B          # what a stage holds where nothing staged


def _mode(name, n):
    (kw,) = [kw for m, _, kw in chip_smoke.shift_modes(n, topology)
             if m == name]
    return kw


def _plan(dirs, n, fused, max_tile, live=False):
    """The plan's words, parsed: (tile, stages, stage words, received's
    offset, cols, windows, directions, each window's slot end in its
    group's stage, groups, each direction's liveness row).  A group is
    (slot, first window, windows, first direction, directions, liveness
    offset); a one-source plan has one, over every window and
    direction, and its directions' rows are their own indices."""
    words = list(kernels._shift_plan(dirs, n, fused, max_tile, live)[0])
    tile, stages, stage_words, rec_at, cols, n_win, n_dirs, live_at = \
        words[:8]
    assert (live_at >= 0) == live
    wins = [tuple(words[8 + 4 * k:12 + 4 * k]) for k in range(n_win)]
    base = 8 + 4 * n_win
    ds = [tuple(words[base + 3 * d:base + 3 * d + 3]) for d in range(n_dirs)]
    tail = words[base + 3 * n_dirs:]
    if dirs.slots:
        n_groups, live_slot = tail[:2]
        assert live_slot == (kernels.live_slot_words(tile) if live else 0)
        groups = [tuple(tail[2 + 6 * g:8 + 6 * g]) for g in range(n_groups)]
        rows = tail[2 + 6 * n_groups:]
        assert len(rows) == n_dirs and live_at == groups[0][5]
    else:
        assert tail == []
        groups = [(0, 0, n_win, 0, n_dirs, live_at)]
        rows = list(range(n_dirs))
    slot_ends = []
    for _, w0, nwin, _, _, g_live in groups:
        slot_ends += [at for _, _, _, at in wins[w0 + 1:w0 + nwin]] + [
            rec_at if fused else g_live if live else stage_words]
    return (tile, stages, stage_words, rec_at, cols, wins, ds, slot_ends,
            groups, rows)


def windows_cover_every_direction(mode, n, max_tile):
    dirs = pst.shift_dirs(mode, n, **_mode(mode, n))
    tile = _plan(dirs, n, True, max_tile)[0]
    assert 1 <= tile <= min(max_tile, n)
    windows = kernels.shift_windows(dirs, n, tile)
    served = sorted(d for win in windows for d in win.dirs)
    assert served == list(range(len(dirs.offs)))
    for win in windows:
        assert win.hi - win.lo <= tile
    for i0 in range(0, n, max(tile, n // 64)):
        tl = min(tile, n - i0)
        for win in windows:
            lo, hi = i0 + win.lo, i0 + win.hi + tl
            for d in win.dirs:
                assert bool(dirs.flags[d] & kernels.WRAP) == win.wrap
                o = kernels.signed_offset(dirs.offs[d], dirs.flags[d], n)
                # the direction's source range, unreduced: mod n for a
                # wrap, as the window takes it
                assert lo <= i0 + o and i0 + o + tl <= hi
                if win.wrap:
                    assert (i0 + o) % n == (i0 + dirs.offs[d]) % n
                else:
                    assert o == dirs.offs[d]
    # each slot holds its window at any phase 0-3, inside the stage
    for fused in (False, True):
        _, stages, stage_words, rec_at, _, wins, _, ends, *_ = _plan(
            dirs, n, fused, max_tile)
        assert stages * 4 * stage_words <= kernels.SHIFT_SMEM_BYTES
        for (lo, span, _, at), end in zip(wins, ends):
            assert at % 4 == 0 and at + 3 + span + tile <= end
        if fused:
            assert rec_at % 4 == 0 and rec_at + 3 + tile <= stage_words
    if mode == "circulant" and n == 1 << 20 and max_tile == 2048:
        assert tile == 2048 and len(windows) == 7


def _stage_and_or(src, received, dirs, max_tile, phase, live=None,
                  live_phase=0):
    """The kernel's staging, emulated: (inbox, new received or None).
    ``src`` is the (W, N) source, or for a ring table (``dirs.slots``)
    the (L, W, N) ring, whose tensor starts at 16-byte phase ``phase``.
    Each (tile, group) unit is staged into a fresh stage — the group's
    windows from its slot, and with ``live`` (packed rows, whose tensor
    starts at phase ``live_phase``) the slices of its directions' rows —
    and the group's directions are ORed out of it into the tile's inbox
    words, which are stored after the tile's last group."""
    ring = src if dirs.slots else src[None]
    _, w, n = ring.shape
    fused = received is not None
    tile, _, stage_words, rec_at, cols, wins, ds, ends, groups, rows = \
        _plan(dirs, n, fused, max_tile, live is not None)
    assert sorted(rows) == list(range(len(dirs.offs)))
    i0 = torch.arange(0, n, tile)
    tl = (n - i0).clamp(max=tile)
    t = torch.arange(tile)
    valid = t[None, :] < tl[:, None]
    tiles = torch.arange(len(i0))[:, None]
    inbox = torch.zeros(ring.shape[1:], dtype=torch.int32)
    new_rec = received.clone() if fused else None

    def stage_range(stage, words, row, at, s, width, wrap, end):
        """Stage words[x] for x in [s, s + width) of each tile at its
        16-byte phase (``row``: the row's index among the tensor's (W,
        N) rows; a wrap range's start taken mod n first, as the kernel
        takes it); returns the phases."""
        if wrap:
            s = s % n
        ph = (phase + row * n + s) % 4
        q = torch.arange(int(width.max()))
        x = s[:, None] + q[None, :]
        inside = q[None, :] < width[:, None]
        if wrap:
            got = words[x % n]
        else:
            got = torch.where((x >= 0) & (x < n), words[x.clamp(0, n - 1)],
                              0)
        slot = at + ph[:, None] + q[None, :]
        assert int(slot[inside].max()) < end, "window spills out of slot"
        stage[tiles.expand_as(slot)[inside], slot[inside]] = got[inside]
        return ph

    def stage_slices(stage, live_at, lrows):
        """Liveness rows ``lrows``' slices, words [i0 / 32, (i0 + tl + 31)
        / 32) of each, one a slot from ``live_at`` at the phase a bulk
        copy would give; returns each one's first slice word."""
        nw = live.shape[1]
        slot = kernels.live_slot_words(tile)
        assert live_at % 4 == 0
        assert live_at + len(lrows) * slot <= stage_words
        s0 = i0 // 32
        cnt = (i0 + tl + 31) // 32 - s0
        q = torch.arange(int(cnt.max()))
        inside = q[None, :] < cnt[:, None]
        firsts = []
        for r, lrow in enumerate(lrows):
            ph = (live_phase + lrow * nw + s0) % 4
            assert int((ph + cnt).max()) <= slot, "slice spills out of slot"
            got = live[lrow][(s0[:, None] + q[None, :]).clamp(max=nw - 1)]
            at = live_at + r * slot + ph[:, None] + q[None, :]
            stage[tiles.expand_as(at)[inside], at[inside]] = got[inside]
            firsts.append(live_at + r * slot + ph)
        return firsts

    col = (i0[:, None] + t[None, :]) % cols if cols > 0 else None
    u = (i0 % 32)[:, None] + t[None, :]         # the bit of node i0 + t
    for row in range(w):
        v = torch.zeros(len(i0), tile, dtype=torch.int32)
        for slot, w0, nwin, d0, nd, live_at in groups:
            assert nd <= kernels.MAX_DIRS
            stage = torch.full((len(i0), stage_words), SENTINEL,
                               dtype=torch.int32)
            ph = {k: stage_range(stage, ring[slot, row], slot * w + row,
                                 wins[k][3], i0 + wins[k][0],
                                 wins[k][1] + tl, wins[k][2], ends[k])
                  for k in range(w0, w0 + nwin)}
            if live is not None:
                sl = stage_slices(stage, live_at, rows[d0:d0 + nd])
            for r, (k, delta, mask) in enumerate(ds[d0:d0 + nd]):
                d = rows[d0 + r]
                # the direction reads its own slot through a window of
                # its group, at its own offset
                assert k in ph and (not dirs.slots or dirs.slots[d] == slot)
                assert wins[k][0] + delta == kernels.signed_offset(
                    dirs.offs[d], dirs.flags[d], n)
                assert mask == dirs.flags[d] & (kernels.MASK_LEFT
                                                | kernels.MASK_RIGHT)
                idx = (wins[k][3] + ph[k][:, None] + delta + t[None, :]
                       ).clamp(max=stage_words - 1)
                term = torch.gather(stage, 1, idx)
                if mask & kernels.MASK_LEFT:
                    term = torch.where(col < cols - 1, term, 0)
                if mask & kernels.MASK_RIGHT:
                    term = torch.where(col > 0, term, 0)
                if live is not None:
                    word = torch.gather(stage, 1, (sl[r][:, None] + u // 32)
                                        .clamp(max=stage_words - 1))
                    term = torch.where((word >> (u % 32)) & 1 == 1, term, 0)
                v |= term
        v = v[valid]
        if fused:
            stage = torch.full((len(i0), stage_words), SENTINEL,
                               dtype=torch.int32)
            rph = stage_range(stage, received[row], row, rec_at, i0, tl,
                              False, stage_words)
            idx = (rec_at + rph[:, None] + t[None, :]).clamp(
                max=stage_words - 1)
            r = torch.gather(stage, 1, idx)[valid]
            fresh = v & ~r
            new_rec[row] = r | fresh
            v = fresh
        inbox[row] = v
    return inbox, new_rec


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _jax_exchange(mode, x, n, kw):
    xj = jnp.asarray(x)
    if mode == "circulant":
        return jst.circulant_exchange(xj, list(kw["strides"]))
    if mode == "ring":
        return jst.ring_exchange(xj)
    if mode == "line":
        return jst.line_exchange(xj)
    return jst.grid_exchange(xj, kw["cols"])


def staged_emulation_matches_plain_and_reference(mode, n, max_tile):
    kw = _mode(mode, n)
    dirs = pst.shift_dirs(mode, n, **kw)
    w = 2 if n < 1 << 20 else 1
    fr, rec = _u32((w, n), seed=n + 1), _u32((w, n), seed=n + 2)
    ft = torch.from_numpy(fr.view(np.int32))
    rt = torch.from_numpy(rec.view(np.int32))
    want = kernels.shift_exchange_plain(ft, dirs)
    np.testing.assert_array_equal(want.numpy().view(np.uint32),
                                  np.asarray(_jax_exchange(mode, fr, n, kw)))
    # a row base at every 16-byte phase (a view 4 bytes into its
    # allocation shifts them all by one)
    for phase in (0, 1):
        got, _ = _stage_and_or(ft, None, dirs, max_tile, phase)
        assert torch.equal(got, want), phase
    want_rec, want_nxt = rt.clone(), torch.empty_like(ft)
    kernels.shift_flood_round_plain(want_rec, ft, want_nxt, dirs)
    got_nxt, got_rec = _stage_and_or(ft, rt, dirs, max_tile, 3)
    assert torch.equal(got_nxt, want_nxt)
    assert torch.equal(got_rec, want_rec)


def masked_plan_places_the_liveness_slices(mode, n, max_tile):
    dirs = pst.shift_dirs(mode, n, **_mode(mode, n))
    tile, stages, stage_words, rec_at, _, wins, ds, ends, *_ = _plan(
        dirs, n, False, max_tile, live=True)
    # the slices do not halve the tile: the same tile and windows as the
    # unmasked exchange's plan
    plain = _plan(dirs, n, False, max_tile)
    assert (tile, wins, ds) == (plain[0], plain[5], plain[6])
    assert rec_at == -1
    slot = kernels.live_slot_words(tile)
    live_at = ends[-1]
    assert live_at % 4 == 0 and slot % 4 == 0
    assert live_at == plain[2]                  # right after the windows
    assert stage_words == live_at + len(dirs.offs) * slot
    assert stages * 4 * stage_words <= kernels.SHIFT_SMEM_BYTES
    # every tile's slice fits its slot at any 16-byte phase
    i0 = np.arange(0, n, tile)
    tl = np.minimum(tile, n - i0)
    assert int(3 + ((i0 + tl + 31) // 32 - i0 // 32).max()) <= slot
    if mode == "circulant" and n == 1 << 20 and max_tile == 2048:
        assert tile == 2048 and slot == 68
        assert stages * 4 * stage_words < 128 * 1024
    with pytest.raises(ValueError, match="fused round"):
        kernels._shift_plan(dirs, n, True, max_tile, True)


def _jax_masked_exchange(mode, x, rows, dirs, kw):
    """The JAX masked exchange over bool rows ordered as ``dirs``; the
    grid's row-wrap column masks folded into its rows, as the reference
    folds them into its exists rows."""
    xj, n = jnp.asarray(x), x.shape[1]
    if mode == "grid":
        col = np.arange(n) % dirs.cols
        rows = rows.copy()
        rows[2] &= col < dirs.cols - 1
        rows[3] &= col > 0
        return jst.grid_masked_exchange(xj, jnp.asarray(rows), kw["cols"])
    if mode == "line":
        return jst.line_masked_exchange(xj, jnp.asarray(rows))
    strides = [1] if mode == "ring" else list(kw["strides"])
    return jst.circulant_masked_exchange(xj, jnp.asarray(rows), strides)


def masked_emulation_matches_plain_and_reference(mode, n, max_tile):
    kw = _mode(mode, n)
    dirs = pst.shift_dirs(mode, n, **kw)
    w = 2 if n < 1 << 20 else 1
    fr = _u32((w, n), seed=n + 3)
    ft = torch.from_numpy(fr.view(np.int32))
    rng = np.random.default_rng(n + 4)
    rows = rng.random((len(dirs.offs), n)) < 0.6
    live = kernels.pack_bits(torch.from_numpy(rows))
    # the words past n random: the kernel must not read those bits
    if n % 32:
        tail = torch.from_numpy(rng.integers(
            0, 1 << 32, len(dirs.offs), dtype=np.uint64).astype(
            np.uint32).view(np.int32)) & ~((1 << n % 32) - 1)
        live[:, -1] |= tail
    want = kernels.shift_masked_exchange_plain(ft, live, dirs)
    np.testing.assert_array_equal(
        want.numpy().view(np.uint32),
        np.asarray(_jax_masked_exchange(mode, fr, rows, dirs, kw)))
    for phase, live_phase in ((0, 0), (1, 1), (0, 3)):
        got, _ = _stage_and_or(ft, None, dirs, max_tile, phase, live,
                               live_phase)
        assert torch.equal(got, want), (phase, live_phase)


# -- the ring mode: a stage a (tile, group) -----------------------------

# delay-value sets whose classes, at round RING_T of a ring of max(v)
# slots, read 1, 2 and 3 slots
RING_VALUES = ((2,), (1, 3), (1, 2, 3))
RING_T = 5


def _ring_dirs(dirs, terms, ring):
    """The ring table of ``(d, v)`` terms at round RING_T: direction d's
    row of ``dirs`` reading the slot of its send round."""
    return kernels.ShiftDirs(
        tuple(dirs.offs[d] for d, _ in terms),
        tuple(dirs.flags[d] for d, _ in terms), dirs.cols,
        tuple(pst.send_slot(RING_T, v, ring) for _, v in terms))


def ring_emulation_matches_plain_and_reference(mode, n, max_tile):
    # per-edge classes (make_edge_delayed: a row a (direction, delay),
    # gated by its packed class row) and per-direction classes
    # (make_delayed: ungated) reading 1, 2 and 3 ring slots; the ring at
    # 16-byte phases 0 and 1, the rows at 3 and 2
    kw = _mode(mode, n)
    dirs = pst.shift_dirs(mode, n, **kw)
    rng = np.random.default_rng(n + len(mode))
    for values in RING_VALUES:
        hist = _u32((max(values), 1, n), seed=n + len(values))
        phase = len(values) % 2
        rows = rng.choice(values, (len(dirs.offs), n)).astype(np.int32)
        pe = pst.make_edge_delayed(mode, n, rows, **kw)
        je = jst.make_edge_delayed(mode, n, rows, **kw)
        # the bundles' ring: the largest delay present
        ht = torch.from_numpy(hist[:pe.ring].view(np.int32))
        table = _ring_dirs(dirs, pe.classes, pe.ring)
        live = pe.class_rows("cpu")
        want = kernels.shift_ring_exchange_plain(ht, table, live)
        np.testing.assert_array_equal(
            want.numpy().view(np.uint32),
            np.asarray(je.exchange(jnp.asarray(hist[:je.ring]), RING_T,
                                   jnp.asarray(rows))))
        got, _ = _stage_and_or(ht, None, table, max_tile, phase, live,
                               3 - phase)
        assert torch.equal(got, want), ("rows", values)
        dd = tuple(values[d % len(values)] for d in range(len(dirs.offs)))
        jb = jst.make_delayed(mode, n, dd, **kw)
        ht = torch.from_numpy(hist[:jb.ring].view(np.int32))
        table = _ring_dirs(dirs, list(enumerate(dd)), jb.ring)
        want = kernels.shift_ring_exchange_plain(ht, table)
        np.testing.assert_array_equal(
            want.numpy().view(np.uint32),
            np.asarray(jb.exchange(jnp.asarray(hist[:jb.ring]), RING_T)))
        got, _ = _stage_and_or(ht, None, table, max_tile, 1 - phase, None,
                               0)
        assert torch.equal(got, want), ("no rows", values)


def ring_emulation_past_a_group(n):
    # a slot of more than MAX_DIRS rows (the circulant's 8 directions
    # three times over, 20 of them in one slot: one window, split into
    # groups of 16 and 4) and 24 rows over 3 slots, one launch each; ring
    # and rows off the 16-byte grid
    dirs = pst.shift_dirs("circulant", n, **_mode("circulant", n))
    reps = 3 * len(dirs.offs)
    ring = torch.from_numpy(_u32((3, 1, n), seed=n).view(np.int32))
    rng = np.random.default_rng(n)
    live = kernels.pack_bits(torch.from_numpy(rng.random((reps, n)) < 0.7))
    for slots in ((0,) * 20 + (2,) * 4, tuple(d // 8 for d in range(reps))):
        table = kernels.ShiftDirs(dirs.offs * 3, dirs.flags * 3, dirs.cols,
                                  slots)
        groups = _plan(table, n, False, kernels.SHIFT_TILE, True)[8]
        assert [nd for *_, nd, _ in groups] == (
            [16, 4, 4] if slots[0] == slots[19] else [8, 8, 8])
        for lv in (None, live):
            want = kernels.shift_ring_exchange_plain(ring, table, lv)
            got, _ = _stage_and_or(ring, None, table, kernels.SHIFT_TILE, 1,
                                   lv, 3)
            assert torch.equal(got, want), lv is None


def ring_plans_of_the_delay_phases_keep_the_tile():
    # w1_circulant_delayed's tables at 2^20 nodes and round 5: the
    # edge-delayed 8 directions x classes {1, 3} (16 rows, 2 slots) with
    # their class rows, and 3 classes (24 rows); the per-direction table
    # (8 rows).  Each keeps the 2048-node tile, a group a slot, and a
    # stage the size of one slot's masked exchange (7 windows, 8 slices),
    # and runs as one launch
    n = 1 << 20
    kw = _mode("circulant", n)
    dirs = pst.shift_dirs("circulant", n, **kw)
    rows, gen = chip_smoke.delay_rows(len(dirs.offs), n)
    masked = _plan(dirs, n, False, kernels.SHIFT_TILE, True)
    assert masked[0] == 2048 and len(masked[5]) == 7
    dd = tuple(int(v) for v in gen.choice([1, 3], len(dirs.offs)))
    rows3 = np.random.default_rng(3).choice([1, 2, 3], rows.shape)
    for table, live, n_slots in (
            (_ring_dirs(dirs, pst.make_edge_delayed(
                "circulant", n, rows, **kw).classes, 3), True, 2),
            (_ring_dirs(dirs, pst.make_edge_delayed(
                "circulant", n, rows3, **kw).classes, 3), True, 3),
            (_ring_dirs(dirs, list(enumerate(dd)), 3), False,
             len(set(dd)))):
        assert len(table.offs) <= kernels.MAX_RING_ROWS      # one launch
        tile, stages, stage_words, *_, groups, _ = _plan(
            table, n, False, kernels.SHIFT_TILE, live)
        assert tile == 2048 and len(groups) == n_slots
        assert sorted(g[0] for g in groups) == sorted(set(table.slots))
        if live:
            assert len(table.offs) == 8 * n_slots
            assert stage_words == masked[2]
            assert [(g[2], g[4]) for g in groups] == [(7, 8)] * n_slots
        assert stages == kernels.SHIFT_STAGES
        assert stages * 4 * stage_words <= kernels.SHIFT_SMEM_BYTES
