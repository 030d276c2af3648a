"""The shift kernels' staging plan (``kernels.shift_windows`` and the
launch plan ``kernels._shift_plan``, also its masked form with liveness
slices), held on the CPU.

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
  JAX masked exchange.
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
    words = list(kernels._shift_plan(dirs, n, fused, max_tile, live)[0])
    tile, stages, stage_words, rec_at, cols, n_win, n_dirs, live_at = \
        words[:8]
    assert (live_at >= 0) == live
    wins = [tuple(words[8 + 4 * k:12 + 4 * k]) for k in range(n_win)]
    base = 8 + 4 * n_win
    ds = [tuple(words[base + 3 * d:base + 3 * d + 3]) for d in range(n_dirs)]
    slot_ends = [at for _, _, _, at in wins[1:]] + [
        rec_at if fused else live_at if live else stage_words]
    return tile, stages, stage_words, rec_at, cols, wins, ds, slot_ends


@pytest.mark.parametrize("max_tile", TILES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", MODES)
def test_windows_cover_every_direction(mode, n, max_tile):
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
        _, stages, stage_words, rec_at, _, wins, _, ends = _plan(
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
    ``live``: the masked exchange over those packed rows, whose tensor
    starts at 16-byte phase ``live_phase``."""
    w, n = src.shape
    fused = received is not None
    tile, _, stage_words, rec_at, cols, wins, ds, ends = _plan(
        dirs, n, fused, max_tile, live is not None)
    i0 = torch.arange(0, n, tile)
    tl = (n - i0).clamp(max=tile)
    t = torch.arange(tile)
    valid = t[None, :] < tl[:, None]
    tiles = torch.arange(len(i0))[:, None]
    inbox = torch.zeros_like(src)
    new_rec = received.clone() if fused else None

    def stage_range(stage, words, row, at, s, width, wrap, end):
        """Stage words[x] for x in [s, s + width) of each tile at its
        16-byte phase (a wrap range's start taken mod n first, as the
        kernel takes it); returns the phases."""
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

    def stage_slices(stage):
        """Each liveness row's slice, words [i0 / 32, (i0 + tl + 31) / 32)
        of the row, in its slot at the phase a bulk copy would give;
        returns each row's first slice word in the stage."""
        nw = live.shape[1]
        slot = kernels.live_slot_words(tile)
        live_at = ends[-1]
        assert stage_words == live_at + len(dirs.offs) * slot
        s0 = i0 // 32
        cnt = (i0 + tl + 31) // 32 - s0
        q = torch.arange(int(cnt.max()))
        inside = q[None, :] < cnt[:, None]
        firsts = []
        for r in range(len(dirs.offs)):
            ph = (live_phase + r * nw + s0) % 4
            assert int((ph + cnt).max()) <= slot, "slice spills out of slot"
            got = live[r][(s0[:, None] + q[None, :]).clamp(max=nw - 1)]
            at = live_at + r * slot + ph[:, None] + q[None, :]
            stage[tiles.expand_as(at)[inside], at[inside]] = got[inside]
            firsts.append(live_at + r * slot + ph)
        return firsts

    for row in range(w):
        stage = torch.full((len(i0), stage_words), SENTINEL,
                           dtype=torch.int32)
        ph = [stage_range(stage, src[row], row, at, i0 + lo, span + tl,
                          wrap, end)
              for (lo, span, wrap, at), end in zip(wins, ends)]
        if live is not None:
            sl = stage_slices(stage)
            u = (i0 % 32)[:, None] + t[None, :]     # the bit of node i0 + t
        v = torch.zeros(len(i0), tile, dtype=torch.int32)
        col = (i0[:, None] + t[None, :]) % cols if cols > 0 else None
        for d, (k, delta, mask) in enumerate(ds):
            idx = (wins[k][3] + ph[k][:, None] + delta + t[None, :]).clamp(
                max=stage_words - 1)
            term = torch.gather(stage, 1, idx)
            if mask & kernels.MASK_LEFT:
                term = torch.where(col < cols - 1, term, 0)
            if mask & kernels.MASK_RIGHT:
                term = torch.where(col > 0, term, 0)
            if live is not None:
                word = torch.gather(stage, 1, (sl[d][:, None] + u // 32)
                                    .clamp(max=stage_words - 1))
                term = torch.where((word >> (u % 32)) & 1 == 1, term, 0)
            v |= term
        v = v[valid]
        if fused:
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


@pytest.mark.parametrize("max_tile", TILES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", MODES)
def test_staged_emulation_matches_plain_and_reference(mode, n, max_tile):
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


@pytest.mark.parametrize("max_tile", LIVE_TILES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", MODES)
def test_masked_plan_places_the_liveness_slices(mode, n, max_tile):
    dirs = pst.shift_dirs(mode, n, **_mode(mode, n))
    tile, stages, stage_words, rec_at, _, wins, ds, ends = _plan(
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


@pytest.mark.parametrize("max_tile", LIVE_TILES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", MODES)
def test_masked_emulation_matches_plain_and_reference(mode, n, max_tile):
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
