"""The port's CUDA kernels on the card: each one against its plain PyTorch
version, and the GPU simulator against the CPU one, bit for bit
(tolerance 0: bitsets and counts).

Every test here needs a CUDA card and skips without one.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu_torch.parallel import topology
from gossip_glomers_tpu_torch.tpu_sim import (broadcast, counter, faults,
                                              kafka,
                                              kernels, structured, timing)

SHAPES = [(w, n) for w in (1, 8, 32, 128) for n in (1, 5, 4097, (1 << 16) + 3)]
# the shift kernels' edge cases: a row one node short of a tile, exactly
# one, one over, two and a ragged third (odd n at W = 128)
TILE = kernels.SHIFT_TILE
SHIFT_EDGES = [(1, TILE - 1), (8, TILE), (1, TILE + 1), (128, 2 * TILE + 3)]
# the row widths (words a node) of the gather kernels' block-edge cases
GATHER_EDGE_WORDS = (1, 3, 8, 32, 128, 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _bits(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         device=device, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 5, 4097, (1 << 16) + 3))
@pytest.mark.parametrize("w", (1, 8, 32, 128))
def test_cuda_kernels_match_plain(cuda_device, w, n):
    rec = _bits((w, n), 2 * n + w, cuda_device)
    fr = _bits((w, n), 2 * n + w + 1, cuda_device)
    before = dict(kernels.LAUNCHES)
    for k in (2, 4):
        assert torch.equal(kernels.tree_exchange(fr, k),
                           kernels.tree_exchange_plain(fr, k))
        got_rec, got_nxt = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round(got_rec, fr, got_nxt, k)
        want_rec, want_nxt = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round_plain(want_rec, fr, want_nxt, k)
        assert torch.equal(got_rec, want_rec)
        assert torch.equal(got_nxt, want_nxt)
    assert torch.equal(kernels.col_popcount(rec),
                       kernels.col_popcount_plain(rec))
    torch.cuda.synchronize()
    after = kernels.LAUNCHES
    assert after["tree_exchange"] == before["tree_exchange"] + 2
    assert after["tree_flood_round"] == before["tree_flood_round"] + 2
    assert after["col_popcount"] == before["col_popcount"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w", (1, 128))
@pytest.mark.parametrize("n", (4, 20, 44, 4096, 4097, 4098, 4099))
def test_cuda_tree_exchange_vector_path(cuda_device, n, w, offset):
    # k = 4 takes four nodes a thread where n % 4 == 0 on 16-byte aligned
    # rows (offset 0); the scalar kernel takes n % 4 != 0, a view 4 bytes
    # in (offset 1) and k = 3
    fr = _bits((w, n), 5 * n + w, cuda_device)
    view = _at_offset(fr, offset)
    before = kernels.LAUNCHES["tree_exchange"]
    for k in (4, 3):
        got = kernels.tree_exchange(view, k)
        assert torch.equal(got, kernels.tree_exchange_plain(fr, k)), k
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tree_exchange"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("n,nv,sync_every", [(4097, 96, 64),
                                             (4097, 96, 3)])
def test_cuda_sim_matches_cpu_sim(cuda_device, n, nv, sync_every, srv):
    inject = broadcast.make_inject(n, nv)
    states = {}
    for dev in ("cpu", cuda_device):
        sim = timing.structured_sim("tree", n, nv, sync_every=sync_every,
                                    srv_ledger=srv, branching=4, device=dev)
        fused, rounds = sim.run_fused(inject)
        state0, _ = sim.stage(inject)
        fixed = sim.run_staged_fixed(state0, rounds)
        states[str(dev)] = (rounds, broadcast.state_to_numpy(fused),
                            broadcast.state_to_numpy(fixed))
    (r_cpu, f_cpu, x_cpu), (r_gpu, f_gpu, x_gpu) = states.values()
    assert r_cpu == r_gpu
    for a, b in ((f_cpu, f_gpu), (x_cpu, x_gpu)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]


def _shift_modes(n):
    """K1's modes at n nodes: circulant (4 strides), ring, line, grids
    whose last row is ragged, and a circulant whose +(T/2 + 3) window
    crosses n in the middle of a tile."""
    return [("circulant", {"strides": topology.expander_strides(n, 8, 0)}),
            ("ring", {}), ("line", {}), ("grid", {}),
            ("grid", {"cols": max(1, topology.grid_cols(n) - 1)}),
            ("circulant", {"strides": [1, TILE // 2 + 3]})]


def _at_offset(x, offset):
    """A contiguous copy of x that starts ``offset`` words into its
    allocation (offset 1: 4 bytes, off the 16-byte grid)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w,n", SHAPES + SHIFT_EDGES)
def test_cuda_shift_kernels_match_plain(cuda_device, w, n, offset):
    rec = _at_offset(_bits((w, n), 3 * n + w, cuda_device), offset)
    fr = _at_offset(_bits((w, n), 3 * n + w + 1, cuda_device), offset)
    assert (fr.data_ptr() % 16 == 4) == (offset == 1)
    before = dict(kernels.LAUNCHES)
    modes = _shift_modes(n)
    for topo, kw in modes:
        dirs = structured.shift_dirs(topo, n, **kw)
        assert torch.equal(kernels.shift_exchange(fr, dirs),
                           kernels.shift_exchange_plain(fr, dirs)), topo
        got_rec = _at_offset(rec, offset)
        got_nxt = _at_offset(torch.empty_like(fr), offset)
        kernels.shift_flood_round(got_rec, fr, got_nxt, dirs)
        want_rec, want_nxt = rec.clone(), torch.empty_like(fr)
        kernels.shift_flood_round_plain(want_rec, fr, want_nxt, dirs)
        assert torch.equal(got_rec, want_rec), topo
        assert torch.equal(got_nxt, want_nxt), topo
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shift_exchange"] \
        == before["shift_exchange"] + len(modes)
    assert kernels.LAUNCHES["shift_flood_round"] \
        == before["shift_flood_round"] + len(modes)


@pytest.mark.cuda
def test_cuda_shift_kernels_refuse_oversized_tables(cuda_device):
    fr = _bits((1, 64), 0, cuda_device)
    dirs = structured.shift_dirs("circulant", 64, strides=list(range(1, 10)))
    with pytest.raises(ValueError, match="directions"):
        kernels.shift_exchange(fr, dirs)


def _gather_inputs(w, n, seed, device):
    rng = np.random.default_rng(seed)
    nbrs = topology.random_regular(n, 8, seed=seed)
    nbrs[rng.random(nbrs.shape) < 0.1] = -1          # padding
    live = rng.random(nbrs.shape) < 0.7
    return (_bits((n, w), seed, device), _bits((n, w), seed + 1, device),
            torch.from_numpy(nbrs).to(device),
            torch.from_numpy(live).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("w,n", SHAPES)
def test_cuda_gather_kernels_match_plain(cuda_device, w, n):
    payload, recv, nbrs, live = _gather_inputs(w, n, n + w, cuda_device)
    before = dict(kernels.LAUNCHES)
    for lv in (None, live):
        assert torch.equal(kernels.gather_or(payload, nbrs, lv),
                           kernels.gather_or_plain(payload, nbrs, lv))
        assert int(kernels.sync_diff_pc(payload, recv, nbrs, lv)) \
            == int(kernels.sync_diff_pc_plain(payload, recv, nbrs, lv))
        got = kernels.gather_flood_round(payload, recv, nbrs, lv)
        want = kernels.gather_flood_round_plain(payload, recv, nbrs, lv)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(kernels.col_popcount(payload, node_major=True),
                       kernels.col_popcount_plain(payload, node_major=True))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_or"] == before["gather_or"] + 2
    assert kernels.LAUNCHES["sync_diff_pc"] == before["sync_diff_pc"] + 2
    assert kernels.LAUNCHES["gather_flood_round"] \
        == before["gather_flood_round"] + 2
    assert kernels.LAUNCHES["col_popcount_nm"] \
        == before["col_popcount_nm"] + 1


def _gather_edge_cases():
    """(w, n, d): per W, the gather kernels' block edges — a block's nodes
    (kernels.gather_nodes_per_block) less one, exactly, one more, and two
    and a ragged third — at degrees 1, 3 and 8."""
    cases = []
    for w in GATHER_EDGE_WORDS:
        per_block = kernels.gather_nodes_per_block(w)
        for n in (per_block - 1, per_block, per_block + 1,
                  2 * per_block + 3):
            cases += [(w, n, d) for d in (1, 3, 8)]
    return cases


@pytest.mark.cuda
def test_cuda_gather_geometry_matches_kernel(cuda_device):
    # the edge cases below sit on the block edges only while the host's
    # copy of the launch geometry is the library's
    lib = kernels._lib("gather_flood")
    for w in GATHER_EDGE_WORDS + (2, 4, 5, 64, 1000):
        assert lib.gg_gather_nodes_per_block(w, 1) \
            == kernels.gather_nodes_per_block(w), w


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w,n,d", _gather_edge_cases())
def test_cuda_gather_edges_match_plain(cuda_device, w, n, d, offset):
    # the three gather kernels at their tile edges, with and without the
    # mask, with payloads of more and fewer rows than nodes (indices past
    # them clipped), on views 4 bytes into their allocation (offset 1:
    # index table, payload, live and recv)
    before = dict(kernels.LAUNCHES)
    calls = 0
    for n_src in (n, n + 37, max(1, n // 2)):
        rng = np.random.default_rng(n * d + n_src)
        nbrs = torch.from_numpy(
            rng.integers(-1, n_src + 3, (n, d)).astype(np.int32)).to(
                cuda_device)
        live = torch.from_numpy(rng.random((n, d)) < 0.7).to(cuda_device)
        payload = _bits((n_src, w), n_src, cuda_device)
        recv = _bits((n, w), n_src + 1, cuda_device)
        views = (_at_offset(payload, offset), _at_offset(recv, offset),
                 _at_offset(nbrs, offset), _at_offset(live, 4 * offset))
        assert (views[0].data_ptr() % 16 == 4) == (offset == 1)
        for lv, lk in ((None, None), (live, views[3])):
            assert torch.equal(kernels.gather_or(views[0], views[2], lk),
                               kernels.gather_or_plain(payload, nbrs, lv))
            assert int(kernels.sync_diff_pc(views[0], views[1], views[2],
                                            lk)) \
                == int(kernels.sync_diff_pc_plain(payload, recv, nbrs, lv))
            got = kernels.gather_flood_round(views[0], views[1], views[2], lk)
            want = kernels.gather_flood_round_plain(payload, recv, nbrs, lv)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert torch.equal(views[1], recv)            # out of place
            calls += 1
    torch.cuda.synchronize()
    for name in ("gather_or", "sync_diff_pc", "gather_flood_round"):
        assert kernels.LAUNCHES[name] == before[name] + calls


@pytest.mark.cuda
def test_cuda_gather_flood_round_on_sync_rounds_is_one_hop(cuda_device):
    # payload IS rec on sync rounds: the fused round writes new buffers,
    # so no bit travels two hops in one launch
    n = 4097
    nbrs = torch.from_numpy(topology.random_regular(n, 8, seed=3)).to(
        cuda_device)
    rec = _bits((n, 3), 5, cuda_device)
    snapshot = rec.clone()
    new, rec_next = kernels.gather_flood_round(rec, rec, nbrs)
    want = kernels.gather_flood_round_plain(snapshot, snapshot, nbrs)
    assert torch.equal(new, want[0]) and torch.equal(rec_next, want[1])
    assert torch.equal(rec, snapshot)


def _run_both(make_sim, inject):
    """(rounds, fused state, fixed state) as numpy on the CPU and the
    card, for a sim factory taking a device."""
    out = []
    for dev in ("cpu", "cuda"):
        sim = make_sim(dev)
        fused, rounds = sim.run_fused(inject)
        state0, _ = sim.stage(inject)
        fixed = sim.run_staged_fixed(state0, rounds)
        wm = sim.words_major
        out.append((rounds,
                    broadcast.state_to_numpy(fused, words_major=wm),
                    broadcast.state_to_numpy(fixed, words_major=wm)))
    return out


def _assert_runs_equal(runs):
    (r_cpu, f_cpu, x_cpu), (r_gpu, f_gpu, x_gpu) = runs
    assert r_cpu == r_gpu
    for a, b in ((f_cpu, f_gpu), (x_cpu, x_gpu)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("windows", (False, True))
def test_cuda_gather_sim_matches_cpu_sim(cuda_device, windows, srv):
    n, nv = 4097, 96
    nbrs = topology.random_regular(n, 8, seed=0)
    group = np.random.default_rng(7).integers(0, 2, (1, n))
    parts = (broadcast.Partitions.from_numpy([2], [9], group) if windows
             else None)
    _assert_runs_equal(_run_both(
        lambda dev: broadcast.BroadcastSim(nbrs, n_values=nv, sync_every=4,
                                           parts=parts, srv_ledger=srv,
                                           device=dev),
        broadcast.make_inject(n, nv)))


@pytest.mark.cuda
@pytest.mark.parametrize("topo,n,kw", [
    ("grid", 4097, {}), ("ring", 301, {}), ("line", 300, {}),
    ("circulant", 4097, {"strides": [1, 5, 77, 901]})])
def test_cuda_shift_sims_match_cpu_sim(cuda_device, topo, n, kw):
    for srv, sync_every in ((False, 1 << 20), (True, 16)):
        _assert_runs_equal(_run_both(
            lambda dev: timing.structured_sim(
                topo, n, 64, sync_every=sync_every, srv_ledger=srv,
                device=dev, **kw),
            broadcast.make_inject(n, 64)))


def _fault_inputs(w, n, seed, device):
    """A -1-padded degree-8 table with indices past the rows (clipped), a
    partition mask, an up vector with a tenth of the nodes down, the
    payload, the dup rows and the receivers' bitsets."""
    rng = np.random.default_rng(seed)
    nbrs = torch.from_numpy(
        rng.integers(-1, n + 3, (n, 8)).astype(np.int32)).to(device)
    live = torch.from_numpy(rng.random((n, 8)) < 0.7).to(device)
    up = torch.from_numpy(rng.random(n) >= 0.1).to(device)
    return (nbrs, live, up, _bits((n, w), seed, device),
            _bits((n, w), seed + 1, device), _bits((n, w), seed + 2, device))


FAULT_COINS = dict(t=11, seed=0xC0FFEE, loss_num=int(0.3 * 2**32),
                   dup_num=int(0.2 * 2**32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w,n", SHAPES)
def test_cuda_fault_kernels_match_plain(cuda_device, w, n, offset):
    # fault_coins and faulted_gather_round against their plain versions:
    # every (loss, dup) stream, with and without the partition mask, on the
    # whole table and on a slab [lo, hi) off the block grid, on views 4
    # bytes into their allocation (offset 1)
    nbrs, live, up, payload, received, rec = _fault_inputs(
        w, n, 5 * n + w, cuda_device)
    lo = min(n - 1, kernels.gather_nodes_per_block(w) // 2 + 1)
    before = dict(kernels.LAUNCHES)
    calls = 0
    for a, b in ((0, n), (lo, max(n - 3, lo + 1))):
        nb, lv, rc = nbrs[a:b], live[a:b], rec[a:b]
        v = {k: _at_offset(x, offset * (4 if x.element_size() == 1 else 1))
             for k, x in (("nb", nb), ("lv", lv), ("rc", rc), ("up", up),
                          ("payload", payload), ("received", received))}
        for loss in (False, True):
            for dup in (False, True):
                for masked in (False, True):
                    kw = dict(FAULT_COINS, loss=loss, dup=dup, out_ok=True,
                              row0=a)
                    flags = kernels.fault_coins(
                        v["nb"], v["up"], live=v["lv"] if masked else None,
                        **kw)
                    want = kernels.fault_coins_plain(
                        nb, up, live=lv if masked else None, **kw)
                    assert torch.equal(flags, want)
                    got = kernels.faulted_gather_round(
                        v["payload"], v["received"] if dup else None,
                        v["rc"], v["nb"], _at_offset(want, 4 * offset))
                    ref = kernels.faulted_gather_round_plain(
                        payload, received if dup else None, rc, nb, want)
                    for g, r in zip(got, ref):
                        assert torch.equal(g, r)
                    calls += 1
    torch.cuda.synchronize()
    for name in ("fault_coins", "faulted_gather_round"):
        assert kernels.LAUNCHES[name] == before[name] + calls


@pytest.mark.cuda
def test_cuda_faulted_geometry_matches_kernel(cuda_device):
    lib = kernels._lib("fault_flood")
    for w in GATHER_EDGE_WORDS + (2, 4, 5, 64, 1000):
        assert lib.gg_faulted_nodes_per_block(w, 1) \
            == kernels.gather_nodes_per_block(w), w


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("crash_loss_dup", "crash_loss_dup_blocked",
                                  "crash_loss_srv_windows", "membership"))
def test_cuda_faulted_gather_sim_matches_cpu_sim(cuda_device, mode):
    n, nv = 4097, 96
    nbrs = topology.random_regular(n, 8, seed=0)
    spec = dict(n_nodes=n, seed=3, crash=((2, 9, tuple(range(0, n, 11))),),
                loss_rate=0.1, loss_until=10)
    kw = dict(n_values=nv, sync_every=4, srv_ledger=False)
    if mode.startswith("crash_loss_dup"):
        spec.update(dup_rate=0.05, dup_until=10)
        if mode.endswith("blocked"):
            kw["union_block"] = 241            # 4097 = 17 x 241
    elif mode == "crash_loss_srv_windows":
        group = np.random.default_rng(7).integers(0, 2, (1, n))
        kw.update(srv_ledger=True, sync_every=3,
                  parts=broadcast.Partitions.from_numpy([2], [12], group))
    else:
        spec.update(join=((3, (5, 6, 7)),), leave=((6, (40,)),))
    spec = faults.NemesisSpec(**spec)
    if mode == "membership":                   # the leaver never converges
        runs = []
        for dev in ("cpu", cuda_device):
            sim = broadcast.BroadcastSim(nbrs, fault_plan=spec.compile(dev),
                                         device=dev, **kw)
            state, rounds = sim.run_fused(broadcast.make_inject(n, nv),
                                          max_rounds=20)
            runs.append((rounds, broadcast.state_to_numpy(
                state, words_major=False)))
        assert runs[0][0] == runs[1][0] == 20
        np.testing.assert_array_equal(runs[0][1][0], runs[1][1][0])
        assert runs[0][1][2:] == runs[1][1][2:]
        return
    before = dict(kernels.LAUNCHES)
    _assert_runs_equal(_run_both(
        lambda dev: broadcast.BroadcastSim(
            nbrs, fault_plan=spec.compile(dev), device=dev, **kw),
        broadcast.make_inject(n, nv)))
    assert kernels.LAUNCHES["fault_coins"] > before["fault_coins"]
    assert kernels.LAUNCHES["faulted_gather_round"] \
        > before["faulted_gather_round"]


def _packed(d, n, mode, seed, device):
    """(d, ceil(n/32)) packed liveness rows: every node live, none, or
    random words (the bits past n random too: no kernel may read them)."""
    if mode == "all":
        return kernels.pack_bits(torch.ones((d, n), dtype=torch.bool,
                                            device=device))
    if mode == "none":
        return torch.zeros((d, kernels.packed_words(n)), dtype=torch.int32,
                           device=device)
    return _bits((d, kernels.packed_words(n)), seed, device)


# the words-major coins' modes: (loss, dup, srv)
WM_STREAMS = ((False, False, False), (True, False, False),
              (False, True, False), (True, True, False),
              (False, False, True), (True, False, True))


# the masked kernels' shapes: small and ragged rows, the shift kernels'
# tile edges, n = 31 (mod 32) (4127; TILE - 1 too) and 1 (mod 32) (4097,
# TILE + 1), and W = 128 at small n
MASKED_SHAPES = ([(w, n) for w in (1, 8) for n in (1, 5, 4097, (1 << 16) + 3)]
                 + SHIFT_EDGES + [(1, 4127), (128, 5), (128, 4097)])
# the tree's branchings: its warp reads k + 1 kids words (k <= 31), which
# a lane's bits straddle at k = 3; 32 takes the word-a-child path
MASKED_BRANCHINGS = (1, 2, 3, 4, 32)
# shift_masked_exchange also through a plan whose tile (1000 nodes) is no
# multiple of 32, so that tiles start inside a liveness word
ODD_TILE = 1000


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("mode", ("all", "none", "random"))
@pytest.mark.parametrize("w,n", MASKED_SHAPES)
def test_cuda_masked_kernels_match_plain(cuda_device, w, n, mode, offset):
    # tree_masked_exchange (its two rows apart) at every branching,
    # shift_masked_exchange in every shift mode at the wrapper's tile and
    # at ODD_TILE, and wm_fault_coins in every stream and the ledger mode,
    # on views 4 bytes into their allocation (offset 1)
    fr = _bits((w, n), 7 * n + w, cuda_device)
    frk = _at_offset(fr, offset)
    before = dict(kernels.LAUNCHES)
    rows = _packed(2, n, mode, n + 1, cuda_device)
    for k in MASKED_BRANCHINGS:
        got = kernels.tree_masked_exchange(frk, _at_offset(rows[0], offset),
                                           _at_offset(rows[1], offset), k)
        assert torch.equal(got, kernels.tree_masked_exchange_plain(
            fr, rows[0], rows[1], k)), k
    modes = _shift_modes(n)
    for topo, kw in modes:
        dirs = structured.shift_dirs(topo, n, **kw)
        live = _packed(len(dirs.offs), n, mode, n + 2, cuda_device)
        want = kernels.shift_masked_exchange_plain(fr, live, dirs)
        for tile in (kernels.SHIFT_TILE, ODD_TILE):
            got = kernels.shift_masked_exchange(
                frk, _at_offset(live, offset), dirs, max_tile=tile)
            assert torch.equal(got, want), (topo, tile)
    # the coins on every topology's descriptors, against the plain version
    # over their materialized id rows
    coin_sets = [structured.coin_dirs("tree", n, degree=deg, branching=k)
                 for k in MASKED_BRANCHINGS for deg in (False, True)]
    coin_sets += [structured.coin_dirs(topo, n, **kw) for topo, kw in modes]
    for rows in coin_sets:
        dirs = torch.from_numpy(rows).to(cuda_device)
        src, dst = kernels.coin_dir_rows(dirs, n)
        live = _packed(len(rows), n, mode, n + 3, cuda_device)
        lk = _at_offset(live, offset)
        for loss, dup, srv in WM_STREAMS:
            kw = dict(FAULT_COINS, loss=loss, dup=dup, srv=srv)
            want = kernels.wm_fault_coins_plain(src, dst, live, **kw)
            got = kernels.wm_fault_coins(dirs, n, lk, **kw)
            for g, x in zip(got, want):
                assert (g is None) == (x is None)
                assert x is None or torch.equal(g, x), (
                    rows.tolist(), loss, dup, srv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tree_masked_exchange"] \
        == before["tree_masked_exchange"] + len(MASKED_BRANCHINGS)
    assert kernels.LAUNCHES["shift_masked_exchange"] \
        == before["shift_masked_exchange"] + 2 * len(modes)
    assert kernels.LAUNCHES["wm_fault_coins"] \
        == before["wm_fault_coins"] + len(WM_STREAMS) * len(coin_sets)


@pytest.mark.cuda
@pytest.mark.parametrize("topo,kw", [
    ("tree", {}), ("grid", {}), ("ring", {}), ("line", {}),
    ("circulant", {"strides": [1, 5, 77, 901]})])
def test_cuda_structured_faults_match_cpu_sim(cuda_device, topo, kw):
    # a partition window (ledger on) and the nemesis composed with it
    # (crash, loss, dup; ledger off), the card against the CPU
    n, nv = 4097, 64
    inject = broadcast.make_inject(n, nv)
    group = np.random.default_rng(7).integers(0, 2, (1, n))
    parts = broadcast.Partitions.from_numpy([2], [9], group)
    before = dict(kernels.LAUNCHES)
    _assert_runs_equal(_run_both(
        lambda dev: timing.structured_sim(topo, n, nv, sync_every=4,
                                          parts=parts, srv_ledger=True,
                                          device=dev, **kw), inject))
    spec = faults.NemesisSpec(n_nodes=n, seed=3,
                              crash=((2, 9, tuple(range(0, n, 11))),),
                              loss_rate=0.1, loss_until=10, dup_rate=0.05,
                              dup_until=10)
    nbrs = timing._nbrs_for(topo, n, **kw)
    _assert_runs_equal(_run_both(
        lambda dev: broadcast.BroadcastSim(
            nbrs, n_values=nv, sync_every=4, srv_ledger=False, parts=parts,
            exchange=structured.make_exchange(topo, n, **kw),
            nemesis=structured.make_nemesis(topo, n, spec, groups=group,
                                            device=dev, **kw),
            fault_plan=spec.compile(dev), device=dev), inject))
    masked = ("tree_masked_exchange" if topo == "tree"
              else "shift_masked_exchange")
    for name in (masked, "wm_fault_coins"):
        assert kernels.LAUNCHES[name] > before[name], name


# the ring kernels' shapes: small and ragged rows (n % 32 != 0, n % 4 in
# {0, 1, 2, 3}), the shift tile's edges, W = 128 at small n, and rows the
# tree's four nodes a thread takes (n % 4 == 0, also n < 16)
RING_SHAPES = ([(w, n) for w in (1, 8) for n in (1, 5, 42, 4097, 4099,
                                                 (1 << 16) + 3)]
               + SHIFT_EDGES + [(128, 5), (128, 4096), (1, 12), (8, 20),
                                (1, (1 << 16) + 4)])


def _tree_tables(rng, slots, rows):
    """The table shapes the modes build: make_delayed's two ungated
    terms, the nemesis's two gated ones, make_edge_delayed's 2 |V| (here
    |V| = 3), a 21-entry random table (two launches) and one with entries
    dropped (a subset)."""
    rand = [(int(rng.integers(0, slots)), int(rng.integers(0, 2)),
             int(rng.integers(-1, rows))) for _ in range(21)]
    return [[(0, 0, -1), (2, 1, -1)], [(1, 0, 0), (0, 1, 1)],
            [(v, kind, 2 * v + kind) for v in range(3) for kind in (0, 1)],
            rand, [e for e in rand if e[0] != 1]]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w,n", RING_SHAPES)
def test_cuda_ring_kernels_match_plain(cuda_device, w, n, offset):
    # tree_ring_exchange at every branching over every table shape (k =
    # 4 on an aligned ring with n % 4 == 0: four nodes a thread; on a
    # view 4 bytes in, offset 1, a node a thread), and shift_ring_exchange
    # in every shift mode with and without rows, at one, two (two delay
    # classes, slots 2 and 0) and three times the directions (up to 24
    # rows: one launch, a group a slot), at the wrapper's tile and
    # ODD_TILE; ring and rows on views 4 bytes into their allocation
    rng = np.random.default_rng(n + w + offset)
    ring = _bits((3, w, n), 5 * n + w, cuda_device)
    rk = _at_offset(ring, offset)
    live = _bits((48, kernels.packed_words(n)), n + 9, cuda_device)
    before = dict(kernels.LAUNCHES)
    tree_launches = 0
    for k in MASKED_BRANCHINGS:
        for table in _tree_tables(rng, 3, 6):
            got = kernels.tree_ring_exchange(
                rk, table, _at_offset(live[:6], offset), k)
            assert torch.equal(got, kernels.tree_ring_exchange_plain(
                ring, table, live[:6], k)), (k, table)
            tree_launches += -(-len(table) // kernels.MAX_RING_ENTRIES)
    shift_launches = 0
    for topo, kw in _shift_modes(n):
        dirs = structured.shift_dirs(topo, n, **kw)
        for reps in (1, 2, 3):
            rows = len(dirs.offs) * reps
            slots = (tuple(int(s) for s in rng.integers(0, 3, rows))
                     if reps != 2 else
                     (2,) * len(dirs.offs) + (0,) * len(dirs.offs))
            table = kernels.ShiftDirs(
                dirs.offs * reps, dirs.flags * reps, dirs.cols, slots)
            lv = _at_offset(live[:rows], offset)
            for rows_on in (False, True):
                want = kernels.shift_ring_exchange_plain(
                    ring, table, live[:rows] if rows_on else None)
                for tile in (kernels.SHIFT_TILE, ODD_TILE):
                    got = kernels.shift_ring_exchange(
                        rk, table, lv if rows_on else None, max_tile=tile)
                    assert torch.equal(got, want), (topo, reps, rows_on,
                                                    tile)
                    shift_launches += 1
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tree_ring_exchange"] \
        == before["tree_ring_exchange"] + tree_launches
    assert kernels.LAUNCHES["shift_ring_exchange"] \
        == before["shift_ring_exchange"] + shift_launches
    # an empty table gives zeros and launches nothing
    assert not kernels.tree_ring_exchange(ring, [], None).any()
    assert not kernels.shift_ring_exchange(
        ring, kernels.ShiftDirs((), (), 0, ())).any()
    assert kernels.LAUNCHES["tree_ring_exchange"] \
        == before["tree_ring_exchange"] + tree_launches


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("w", (1, 8))
def test_cuda_ring_kernels_on_the_delay_tables(cuda_device, w, offset):
    # the delay phases' tables at 2^20 nodes, round 5 of a 3-slot ring:
    # the circulant's edge-delayed 16 rows (8 directions x classes {1,
    # 3}) and 24 rows (classes {1, 2, 3}), each with its class rows, and
    # the tree's 4 entries (four nodes a thread on the aligned ring); one
    # launch each
    n = 1 << 20
    strides = topology.expander_strides(n, 8, 0)
    dirs = structured.shift_dirs("circulant", n, strides=strides)
    ring = _bits((3, w, n), w + offset, cuda_device)
    rk = _at_offset(ring, offset)
    rng = np.random.default_rng(11)
    before = dict(kernels.LAUNCHES)
    for values in ((1, 3), (1, 2, 3)):
        rows = rng.choice(values, (len(dirs.offs), n))
        ed = structured.make_edge_delayed("circulant", n, rows,
                                          strides=strides)
        live = ed.class_rows(cuda_device)
        table = kernels.ShiftDirs(
            tuple(dirs.offs[d] for d, _ in ed.classes),
            tuple(dirs.flags[d] for d, _ in ed.classes), dirs.cols,
            tuple(structured.send_slot(5, v, 3) for _, v in ed.classes))
        assert len(table.offs) == 8 * len(values)
        got = kernels.shift_ring_exchange(rk, table,
                                          _at_offset(live, offset))
        assert torch.equal(got, kernels.shift_ring_exchange_plain(
            ring, table, live)), values
    rows = rng.choice((1, 3), (2, n))
    ed = structured.make_edge_delayed("tree", n, rows)
    live = ed.class_rows(cuda_device)
    table = [(structured.send_slot(5, v, 3), d, j)
             for j, (d, v) in enumerate(ed.classes)]
    got = kernels.tree_ring_exchange(rk, table, _at_offset(live, offset), 4)
    assert torch.equal(got, kernels.tree_ring_exchange_plain(ring, table,
                                                             live, 4))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shift_ring_exchange"] \
        == before["shift_ring_exchange"] + 2
    assert kernels.LAUNCHES["tree_ring_exchange"] \
        == before["tree_ring_exchange"] + 1


def _assert_ring_runs_equal(runs):
    """:func:`_assert_runs_equal` for delay modes: the states' rings too."""
    (r_cpu, f_cpu, x_cpu), (r_gpu, f_gpu, x_gpu) = runs
    assert r_cpu == r_gpu
    for a, b in ((f_cpu, f_gpu), (x_cpu, x_gpu)):
        for i in (0, 1, 5):
            np.testing.assert_array_equal(a[i], b[i])
        assert a[2:5] == b[2:5]


@pytest.mark.cuda
@pytest.mark.parametrize("topo,kw", [
    ("tree", {}), ("grid", {}), ("ring", {}), ("line", {}),
    ("circulant", {"strides": [1, 5, 77, 901]})])
def test_cuda_delay_modes_match_cpu_sim(cuda_device, topo, kw):
    # per-direction classes (ledger on), random per-edge delays alone and
    # under a partition window, the nemesis's dir_delays, and the gather
    # ring on the same graph: the card against the CPU
    n, nv = 4097, 64
    inject = broadcast.make_inject(n, nv)
    group = np.random.default_rng(7).integers(0, 2, (1, n))
    parts = broadcast.Partitions.from_numpy([2], [9], group)
    nbrs = timing._nbrs_for(topo, n, **kw)
    d = 2 if topo == "tree" else len(structured.shift_dirs(topo, n, **kw).offs)
    dd = tuple(1 + i % 3 for i in range(d))
    rows = np.random.default_rng(11).choice([1, 3], (d, n), p=[0.7, 0.3])
    ex = structured.make_exchange(topo, n, **kw)
    before = dict(kernels.LAUNCHES)
    sims = [
        lambda dev: broadcast.BroadcastSim(
            nbrs, n_values=nv, sync_every=6, exchange=ex,
            sync_diff=structured.make_sync_diff(topo, n, **kw),
            delayed=structured.make_delayed(topo, n, dd, **kw), device=dev),
        lambda dev: broadcast.BroadcastSim(
            nbrs, n_values=nv, sync_every=6, exchange=ex,
            edge_delayed=structured.make_edge_delayed(topo, n, rows, **kw),
            device=dev),
        lambda dev: broadcast.BroadcastSim(
            nbrs, n_values=nv, sync_every=6, exchange=ex, parts=parts,
            edge_delayed=structured.make_edge_delayed_faulted(
                topo, n, rows, group, **kw), device=dev),
        lambda dev: broadcast.BroadcastSim(
            nbrs, n_values=nv, sync_every=6, parts=parts, device=dev,
            delays=structured.gather_delays_from_rows(topo, n, rows, nbrs,
                                                      **kw))]
    spec = faults.NemesisSpec(n_nodes=n, seed=3,
                              crash=((2, 9, tuple(range(0, n, 11))),),
                              loss_rate=0.1, loss_until=10, dup_rate=0.05,
                              dup_until=10)
    sims.append(lambda dev: broadcast.BroadcastSim(
        nbrs, n_values=nv, sync_every=4, srv_ledger=False, parts=parts,
        exchange=ex, fault_plan=spec.compile(dev), device=dev,
        nemesis=structured.make_nemesis(topo, n, spec, groups=group,
                                        dir_delays=dd, device=dev, **kw)))
    for make in sims:
        _assert_ring_runs_equal(_run_both(make, inject))
    ring = "tree_ring_exchange" if topo == "tree" else "shift_ring_exchange"
    for name in (ring, "gather_or", "wm_fault_coins"):
        assert kernels.LAUNCHES[name] > before[name], name


def _counter_case(n, seed, device, gate):
    """A counter round's operands: pending in [-3, 10) with one node in
    64 near 2^30, cached fresh (== kv0) at half the nodes, a gate byte of
    every kind at a quarter of them."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=gen)

    kv0 = ints(-5, 5, ())
    pending = torch.where(ints(0, 64, (n,)) == 0,
                          ints(1 << 29, 1 << 30, (n,)), ints(-3, 10, (n,)))
    cached = torch.where(ints(0, 2, (n,)) == 0, kv0, ints(-5, 5, (n,)))
    g = ints(0, 16, (n,))
    gates = torch.where(g < 12, 0, g & 3).to(torch.uint8) if gate else None
    return pending, cached, gates, kv0, ints(0, 1 << 32, (), torch.int64)


# the counter kernels' shapes: chip_smoke.py's kernel_check ones
COUNTER_NS = (1, 31, (1 << 20) + 3, 1 << 24)
# (n, cas, wide): the packed layout only below 24 row bits
COUNTER_CASES = [(n, cas, wide) for n in COUNTER_NS
                 for cas, wide in ((True, False), (True, True),
                                   (False, False))
                 if wide or not cas or (n - 1).bit_length() < 24]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("gate", (False, True))
@pytest.mark.parametrize("n,cas,wide", COUNTER_CASES)
def test_cuda_counter_kernels_match_plain(cuda_device, n, cas, wide, gate,
                                          offset):
    row_bits = max(1, (n - 1).bit_length())
    pending, cached, gates, kv0, msgs = _counter_case(
        n, n + 2 * gate + offset, cuda_device, gate)
    views = [None if x is None else _at_offset(x, offset)
             for x in (pending, cached, gates)]
    kw = dict(cas=cas, wide=wide, row_bits=row_bits, t=7, seed=n,
              poll=bool(offset) != gate)
    wk, wp = kernels.counter_work(cuda_device), \
        kernels.counter_work(cuda_device)
    before = dict(kernels.LAUNCHES)
    kv, m = kernels.counter_select(*views, kv0, msgs, wk, **kw)
    kv_p, m_p = kernels.counter_select_plain(pending, cached, gates, kv0,
                                             msgs, wp, **kw)
    assert int(kv) == int(kv_p) and int(m) == int(m_p)
    # the winner, and the work words back at rest
    assert torch.equal(wk, wp)
    for stale in ({}, {"stale_num": 1 << 31, "stale_seed": 5, "t": 3}):
        akw = dict(cas=cas, poll=kw["poll"], **stale)
        got = kernels.counter_apply(*views, kv, wk, **akw)
        want = kernels.counter_apply_plain(pending, cached, gates, kv_p, wp,
                                           **akw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        into = [_at_offset(x, offset) for x in (pending, cached)]
        kernels.counter_apply(*into, views[2], kv, wk, out=into, **akw)
        assert all(torch.equal(a, b) for a, b in zip(into, want))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["counter_select"] == \
        before["counter_select"] + 1
    assert kernels.LAUNCHES["counter_apply"] == before["counter_apply"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cas-packed", "cas-wide", "allreduce-plan",
                                  "device-kv-stale"])
def test_cuda_counter_sim_matches_cpu_sim(cuda_device, case):
    # a CUDA CounterSim round by round against the CPU one: a KV window,
    # a crash + loss plan with amnesia (the allreduce gate in slabs), the
    # device KV with kv_amnesia and stale coins
    n = 4099
    rng = np.random.default_rng(3)
    deltas = rng.integers(0, 9, n).astype(np.int32)
    blocked = rng.random((2, n)) < 0.3
    spec = faults.NemesisSpec(n_nodes=n, seed=4,
                              crash=((2, 6, tuple(range(0, n, 7))),),
                              loss_rate=0.2, loss_until=9)
    kw = {"cas-packed": dict(mode="cas", winner_key="packed"),
          "cas-wide": dict(mode="cas", winner_key="wide"),
          "allreduce-plan": dict(mode="allreduce", union_block=1024),
          "device-kv-stale": dict(mode="cas", kv_backend="device",
                                  kv_amnesia=True, stale_prob=0.3,
                                  stale_until=10)}[case]

    def sim(dev):
        extra = {}
        if case in ("allreduce-plan", "device-kv-stale"):
            extra["fault_plan"] = spec.compile(dev)
        return counter.CounterSim(
            n, poll_every=3, seed=5, device=dev,
            kv_sched=counter.KVReach.from_numpy([1, 4], [5, 12], blocked),
            **kw, **extra)

    gsim, csim = sim(cuda_device), sim("cpu")
    gs = gsim.add(gsim.init_state(), deltas)
    cs = csim.add(csim.init_state(), deltas)
    before = dict(kernels.LAUNCHES)
    for r in range(20):
        gs, cs = gsim.step(gs), csim.step(cs)
        assert gs.t == cs.t
        for f in ("pending", "cached", "kv", "msgs"):
            assert torch.equal(getattr(gs, f).cpu(), getattr(cs, f)), (r, f)
        if cs.rows is not None:
            assert torch.equal(gs.rows.vals.cpu(), cs.rows.vals)
            assert torch.equal(gs.rows.vers.cpu(), cs.rows.vers)
    torch.cuda.synchronize()
    for name in ("counter_select", "counter_apply"):
        assert kernels.LAUNCHES[name] == before[name] + 20
    fused = gsim.run_fused(gsim.add(gsim.init_state(), deltas), 20)
    assert int(fused.kv) == int(cs.kv) and int(fused.msgs) == int(cs.msgs)
    assert torch.equal(fused.pending.cpu(), cs.pending)


# -- the Kafka round -------------------------------------------------------


def kafka_case(n, k, c, s, seed, device):
    """A Kafka kernel case from ``seed``: sparse random presence, origin,
    union-row, carry and own words; caches, requests and cells around the
    capacity; bool rows of every kind; and N S sends of which about 3 in 4
    hold a distinct (key, slot) bit."""
    rng = np.random.default_rng(seed)
    wc = (c + 31) // 32

    def words(*shape, density=0.1):
        bits = rng.random((*shape, wc * 32)) < density
        bits[..., c:] = False              # no slot past the capacity
        w = (bits.reshape(*shape, wc, 32)
             * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1)
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(
            device)

    def rows(p=0.5):
        return torch.from_numpy(rng.random(n) < p).to(device)

    def ints(lo, hi, *shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape).astype(np.int32)).to(device)

    m = n * s
    cell = np.resize(rng.permutation(k * c), m)
    slot = cell % c
    # no bit is left for the sends past the K C cells
    has = (rng.random(m) < 0.75) & (np.arange(m) < k * c)
    widx = np.where(has, (cell // c) * wc + slot // 32, -1).astype(np.int32)
    bit = np.where(has, np.uint32(1) << (slot % 32).astype(np.uint32),
                   0).astype(np.uint32).view(np.int32)
    req = ints(-1, c + 3, n, k)
    req = torch.where(ints(0, 3, n, k) == 0, req, -1)
    return dict(present=words(n, k), lc=ints(0, c + 1, n, k),
                origin=words(n, k), row=words(k, density=0.05),
                carry=words(n, k, density=0.05),
                own=words(n, k, density=0.05), wipe=rows(0.2), live=rows(),
                req=req, want_ok=rows(0.8), reach=rows(0.8),
                kv_sent=torch.where(ints(0, 4, k) == 0, 0,
                                    ints(1, c + 2, k)),
                tally=rows(), take=rows(0.7),
                widx=torch.from_numpy(widx).to(device),
                bit=torch.from_numpy(bit).to(device), up=rows(0.8))


# (n, k, c, s); the last one's rows (K Wc = 64,000 words) are too wide to
# stage in shared memory: kafka_nem_deliver's global-atomics path
KAFKA_SHAPES = [(1, 1, 1, 1), (3, 7, 32, 2), (31, 7, 33, 3), (31, 1, 128, 1),
                (200, 300, 128, 4), (1000, 10, 64, 1), (5, 16_000, 128, 3)]


def _kafka_merge_modes():
    for deliver in ((), ("row",), ("carry",), ("carry", "own")):
        for wipe in (False, True):
            for resync in (kernels.RESYNC_NONE, kernels.RESYNC_PULL,
                           kernels.RESYNC_PUSH):
                yield deliver, wipe, resync


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("n,k,c,s", KAFKA_SHAPES)
def test_cuda_kafka_kernels_match_plain(cuda_device, n, k, c, s, offset):
    # every mode of the four kernels against their plain versions, the
    # state in place, on aligned tensors and 4-byte-offset views (the
    # word-at-a-time path)
    case = kafka_case(n, k, c, s, n + k + c + offset, cuda_device)

    def view(name):
        return _at_offset(case[name], offset)

    before = dict(kernels.LAUNCHES)
    launches = 0
    for deliver, wipe, resync in _kafka_merge_modes():
        kw = {name: view(name) for name in deliver}
        if wipe:
            kw["wipe"] = case["wipe"]
        if resync:
            kw.update(resync=resync, live=case["live"], origin=view("origin"))
        pk, lk = view("present"), view("lc")
        got = kernels.kafka_merge(pk, lk, **kw)
        pp, lp = case["present"].clone(), case["lc"].clone()
        want = kernels.kafka_merge_plain(pp, lp, **kw)
        launches += 1
        assert torch.equal(pk, pp) and torch.equal(lk, lp), (deliver, wipe)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b), (deliver, wipe, resync)
    union = kernels.kafka_merge_plain(
        case["present"].clone(), case["lc"].clone(),
        resync=kernels.RESYNC_PULL, live=case["live"])[0]
    for take in (None, "take"):
        for req in (None, "req"):
            for want_ok in (None, "want_ok"):
                if take is None and req is None:
                    continue
                kw = dict(take=case.get(take), union=union,
                          req=None if req is None else view("req"),
                          want_ok=case.get(want_ok), reach=case["reach"],
                          kv_sent=case["kv_sent"], tally=case["tally"])
                pk, lk = view("present"), view("lc")
                got = kernels.kafka_commit_select(pk, lk, **kw)
                pp, lp = case["present"].clone(), case["lc"].clone()
                want = kernels.kafka_commit_select_plain(pp, lp, **kw)
                launches += 1
                assert torch.equal(pk, pp) and torch.equal(lk, lp)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                if req is None:
                    continue
                msgs = torch.tensor(4294967290, dtype=torch.int64,
                                    device=cuda_device)
                akw = dict(kv_retries=10, tally_mult=n - 1)
                got = kernels.kafka_commit_apply(
                    lk, kw["req"], *want[:2], case["kv_sent"], case["reach"],
                    kw["want_ok"], want[2], msgs, **akw)
                want = kernels.kafka_commit_apply_plain(
                    lp, case["req"], *want[:2], case["kv_sent"],
                    case["reach"], kw["want_ok"], want[2], msgs, **akw)
                assert torch.equal(lk, lp)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["kafka_merge"] == before["kafka_merge"] + 24
    assert kernels.LAUNCHES["kafka_commit_select"] == \
        before["kafka_commit_select"] + 6
    assert kernels.LAUNCHES["kafka_commit_apply"] == \
        before["kafka_commit_apply"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,c,s", KAFKA_SHAPES)
def test_cuda_kafka_nem_deliver_matches_plain(cuda_device, n, k, c, s):
    # the faulted origin union over the whole axis and over slabs that do
    # not divide it, loss on (0.4) and off
    case = kafka_case(n, k, c, s, 7 * n + s, cuda_device)
    wc = (c + 31) // 32
    for loss_num in (0, int(0.4 * 2**32)):
        for step in (n, 7, 3):
            got = torch.full((n, k, wc), -1, dtype=torch.int32,
                             device=cuda_device)
            want = got.clone()
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                kw = dict(s_dim=s, lo=lo, hi=hi, t=5, seed=11,
                          loss_num=loss_num)
                kernels.kafka_nem_deliver(got, case["widx"], case["bit"],
                                          case["up"], **kw)
                kernels.kafka_nem_deliver_plain(want, case["widx"],
                                                case["bit"], case["up"],
                                                **kw)
            assert torch.equal(got, want), (loss_num, step)


KAFKA_SIM_CASES = {
    "union-commits": dict(),
    "nem-pull": dict(plan=True),
    "nem-push-blocked": dict(plan=True, resync_mode="push", union_block=37),
    "matmul-push": dict(plan=True, resync_mode="push", repl_fast=False),
    "device-kv-amnesia": dict(plan=True, kv_backend="device",
                              kv_amnesia=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KAFKA_SIM_CASES))
def test_cuda_kafka_sim_matches_cpu_sim(cuda_device, case):
    # a CUDA KafkaSim round by round against the CPU one: commits, a KV
    # window, a crash + loss plan with pull and push resync, materialized,
    # in slabs and through the matmul oracle, and the device KV
    kw = dict(KAFKA_SIM_CASES[case])
    n, k, cap, s, rounds = 111, 13, 64, 2, 14
    rng = np.random.default_rng(5)
    sks = rng.integers(-1, k, (rounds, n, s)).astype(np.int32)
    svs = rng.integers(0, 1 << 20, (rounds, n, s)).astype(np.int32)
    crs = np.where(rng.random((rounds, n, k)) < 0.2,
                   rng.integers(1, 8, (rounds, n, k)), -1).astype(np.int32)
    blocked = rng.random((1, n)) < 0.3
    spec = faults.NemesisSpec(n_nodes=n, seed=4,
                              crash=((2, 6, tuple(range(0, n, 7))),),
                              loss_rate=0.2, loss_until=9)

    def sim(dev):
        extra = dict(kw)
        if extra.pop("plan", False):
            extra["fault_plan"] = spec.compile(dev)
        return kafka.KafkaSim(
            n, k, cap, max_sends=s, device=dev,
            kv_sched=counter.KVReach.from_numpy([1], [4], blocked), **extra)

    gsim, csim = sim(cuda_device), sim("cpu")
    gs, cs = gsim.init_state(), csim.init_state()
    before = dict(kernels.LAUNCHES)
    for r in range(rounds):
        gs = gsim.step(gs, sks[r], svs[r], crs[r])
        cs = csim.step(cs, sks[r], svs[r], crs[r])
        assert gs.t == cs.t
        for f in ("log_vals", "present", "kv_val", "local_committed",
                  "origin_bits", "msgs"):
            assert torch.equal(getattr(gs, f).cpu(), getattr(cs, f)), (r, f)
        if cs.rows is not None:
            assert torch.equal(gs.rows.vals.cpu(), cs.rows.vals)
            assert torch.equal(gs.rows.vers.cpu(), cs.rows.vers)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["kafka_merge"] == before["kafka_merge"] + rounds
    assert kernels.LAUNCHES["kafka_commit_apply"] == \
        before["kafka_commit_apply"] + rounds
    if "plan" in kw and kw.get("repl_fast") is not False:
        assert kernels.LAUNCHES["kafka_nem_deliver"] > \
            before["kafka_nem_deliver"]
    fused = gsim.run_fused(gsim.init_state(), sks, svs, crs)
    assert torch.equal(fused.present.cpu(), cs.present)
    assert int(fused.msgs) == int(cs.msgs)


@pytest.mark.cuda
def test_cuda_kafka_auto_union_block_is_one_launch(cuda_device,
                                                    monkeypatch):
    # "auto" sizes its slab by the coin tensor only the plain version
    # builds: under a zero budget the CPU sweeps slabs of one row, the
    # card launches kafka_nem_deliver once a round; an integer keeps its
    # slabs on both
    monkeypatch.setenv("GG_UNION_BLOCK_BUDGET_MB", "0")
    n, k, cap, s = 24, 5, 64, 2
    spec = faults.NemesisSpec(n_nodes=n, seed=3, crash=((0, 2, (1, 7)),),
                              loss_rate=0.2, loss_until=3)

    def sim(dev, block):
        return kafka.KafkaSim(n, k, cap, max_sends=s, device=dev,
                              union_block=block,
                              fault_plan=spec.compile(dev))

    assert sim("cpu", "auto")._ub == 1
    assert sim(cuda_device, "auto")._ub is None
    assert sim(cuda_device, 5)._ub == sim("cpu", 5)._ub == 4
    rng = np.random.default_rng(2)
    sks = rng.integers(0, k, (n, s)).astype(np.int32)
    svs = rng.integers(0, 1000, (n, s)).astype(np.int32)
    gsim, csim = sim(cuda_device, "auto"), sim("cpu", "auto")
    before = kernels.LAUNCHES["kafka_nem_deliver"]
    gs = gsim.step(gsim.init_state(), sks, svs)
    assert kernels.LAUNCHES["kafka_nem_deliver"] == before + 1
    cs = csim.step(csim.init_state(), sks, svs)
    assert torch.equal(gs.present.cpu(), cs.present)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KAFKA_SIM_CASES))
def test_cuda_kafka_rounds_make_no_host_sync(cuda_device, case):
    # staged on the card, a run of Kafka rounds (commits, the resync, the
    # matmul's link mask, the device KV) never waits for the card on the
    # host: torch's sync debug mode raises on any such operation
    kw = dict(KAFKA_SIM_CASES[case])
    n, k, cap, s, rounds = 64, 9, 64, 2, 10
    rng = np.random.default_rng(8)
    staged = [torch.from_numpy(x).to(cuda_device) for x in (
        rng.integers(-1, k, (rounds, n, s)).astype(np.int32),
        rng.integers(0, 1000, (rounds, n, s)).astype(np.int32),
        np.where(rng.random((rounds, n, k)) < 0.3,
                 rng.integers(1, 6, (rounds, n, k)), -1).astype(np.int32))]
    if kw.pop("plan", False):
        kw["fault_plan"] = faults.NemesisSpec(
            n_nodes=n, seed=2, crash=((1, 5, (0, 9)),), loss_rate=0.3,
            loss_until=8).compile(cuda_device)
    sim = kafka.KafkaSim(n, k, cap, max_sends=s, device=cuda_device, **kw)
    st = sim.init_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = sim.run_fused(st, *staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert st.t == rounds and int(st.kv_val.sum()) > 0


# -- the traffic drivers' AND fold -----------------------------------------

# words-major (W, N) and node-major (N, C) shapes: W = 1, ragged N, the
# column form's block edges, and the serving phases' widths
AND_FOLD_WM = [(1, 1), (1, 5), (3, 4097), (1, 65539), (768, 1000),
               (256, 4099)]
AND_FOLD_NM = [(5, 1), (4097, 1), (1000, 3), (513, 33), (70000, 128),
               (1000, 384), (3, 257)]


def _chip_smoke():
    """chip_smoke.py as a module: its probe bitsets (``fold_input``)
    and provenance cases (``prov_case``, ``prov_pairs``)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("shape", AND_FOLD_WM + AND_FOLD_NM)
def test_cuda_and_fold_matches_and_rows(cuda_device, shape, offset):
    # chip_smoke's probe bitset: every line clears a bit of its own at
    # its first and last nodes, the head and tail words of this offset's
    # view and its blocks' edges, so a skipped node range shows
    node_major = shape in AND_FOLD_NM
    n, c = shape if node_major else shape[::-1]
    x = _chip_smoke().fold_input((node_major, n, c), sum(shape),
                                 cuda_device, offset)
    view = _at_offset(x, offset)
    before = kernels.LAUNCHES["and_fold"]
    got = kernels.and_fold(view, node_major=node_major)
    want = kernels.and_rows(x if node_major else x.t())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["and_fold"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), kernels.and_fold(x.cpu(), node_major))
    assert int(got.ne(0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,c", [(64, 64, 185), (1000, 3, 33), (7, 1, 1)])
def test_cuda_and_fold_on_kafka_presence(cuda_device, n, k, c):
    wc = (c + 31) // 32
    present = _chip_smoke().fold_input((True, n, k * wc), n + k,
                                       cuda_device).view(n, k, wc)
    got = kernels.and_fold(present.view(n, k * wc), node_major=True)
    assert torch.equal(got.view(k, wc),
                       kernels.and_rows(present.flatten(1)).view(k, wc))


def _traffic_pairs(device):
    """The traffic drivers on the card and on the CPU at one spec."""
    from gossip_glomers_tpu_torch.tpu_sim import traffic

    n = 256
    spec = traffic.TrafficSpec(n_nodes=n, n_clients=256, ops_per_client=4,
                               until=8, rate=0.3, seed=4)
    nspec = faults.NemesisSpec(n_nodes=n, seed=3, crash=((2, 5, (1, 9)),),
                               loss_rate=0.2, loss_until=7)
    nbrs = topology.to_padded_neighbors(topology.tree(n))

    def bc(dev, wm):
        kw = dict(exchange=structured.make_exchange("tree", n)) if wm else {}
        return broadcast.BroadcastSim(nbrs, n_values=1024, sync_every=4,
                                      srv_ledger=False, device=dev, **kw)

    def kf(dev):
        return kafka.KafkaSim(n, 8, 64, max_sends=2, device=dev,
                              fault_plan=nspec.compile(dev),
                              union_block=64)

    def ct(dev):
        return counter.CounterSim(n, mode="cas", poll_every=2, device=dev,
                                  fault_plan=nspec.compile(dev))

    # (name, card sim, CPU sim, spec, and_fold launches a round)
    return [("broadcast_wm", bc(device, True), bc("cpu", True), spec, 1),
            ("broadcast_gather", bc(device, False), bc("cpu", False), spec,
             1),
            ("kafka_union_nem", kf(device), kf("cpu"), spec, 1),
            ("counter_cas_plan", ct(device), ct("cpu"), spec, 0)]


def _fresh(sim):
    if isinstance(sim, broadcast.BroadcastSim):
        return sim.init_state(np.zeros((sim.n_nodes, sim.n_words), np.uint32))
    return sim.init_state()


@pytest.mark.cuda
def test_cuda_run_traffic_goes_through_and_fold(cuda_device, monkeypatch):
    # every CUDA round of the broadcast and Kafka drivers folds with the
    # kernel, never with its plain version; every driver makes no host
    # sync and equals the CPU driver
    from gossip_glomers_tpu_torch.tpu_sim import traffic

    def refuse(*args, **kw):
        raise AssertionError("the plain AND fold ran on a CUDA run")

    for name, gsim, csim, spec, folds in _traffic_pairs(cuda_device):
        rounds = 12
        gst, gts = _fresh(gsim), gsim.traffic_state(spec)
        with monkeypatch.context() as m:
            m.setattr(kernels, "and_fold_plain", refuse)
            m.setattr(kernels, "and_rows", refuse)
            before = kernels.LAUNCHES["and_fold"]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                gst, gts = gsim.run_traffic(gst, gts, spec, rounds,
                                            donate=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["and_fold"] == before + folds * rounds, \
                name
        cst, cts = csim.run_traffic(_fresh(csim), csim.traffic_state(spec),
                                    spec, rounds)
        for a, b in zip(gts, cts):
            assert torch.equal(a.cpu(), b), name
        assert traffic.latency_summary(gts)["completed"] > 0, name


# -- the provenance record of the gather round (prov_flood.cu) -----------

PROV_CUDA_SHAPES = [(1, 1, 1, 1), (5, 1, 7, 3), (37, 3, 70, 7),
                    (4097, 2, 45, 5), ((1 << 16) + 3, 1, 32, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROV_CUDA_SHAPES)
@pytest.mark.parametrize("mode", ("plain", "partitions", "plan", "plan_dup",
                                  "delays", "delays_plan"))
def test_cuda_prov_attribute_matches_plain(cuda_device, mode, shape):
    # chip_smoke's seeded inputs: ragged values (V not a multiple of 32,
    # spare words), padded directions, every attribution mode
    smoke = _chip_smoke()
    n, w, nv, d = shape
    case = smoke.prov_case(kernels, mode, n, w, nv, d, n + d + len(mode),
                           cuda_device)
    before = kernels.LAUNCHES["prov_attribute"]
    pairs = smoke.prov_pairs(kernels, case)
    for got, want in pairs:
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prov_attribute"] == before + 1
    # the same call on CPU tensors (the plain version) stamps the same
    cpu = {k: v.cpu() for k, v in case.items()
           if isinstance(v, torch.Tensor)}
    arr, par = cpu["arrival"].clone(), cpu["parent"].clone()
    kernels.prov_attribute(cpu["new"], cpu["src"], cpu["nbrs"], arr, par,
                           t_next=case["t_next"],
                           **{k: v.cpu() for k, v in case["edges"].items()})
    assert torch.equal(pairs[0][0].cpu(), arr)
    assert torch.equal(pairs[1][0].cpu(), par)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("plan_dup", "delays_plan", "partitions"))
def test_cuda_run_observed_goes_through_prov_attribute(cuda_device, mode,
                                                       monkeypatch):
    # every observed CUDA round stamps with the kernel, never with its
    # plain version, and the record and state equal the CPU driver's
    def refuse(*args, **kw):
        raise AssertionError("the plain attribution ran on a CUDA run")

    n, nv, rounds = 300, 70, 14
    nbrs = topology.to_padded_neighbors(topology.tree(n))
    spec = faults.NemesisSpec(n_nodes=n, seed=7, crash=((2, 5, (1, 150)),),
                              loss_rate=0.15, loss_until=8,
                              **({"dup_rate": 0.1, "dup_until": 8}
                                 if mode == "plan_dup" else {}))
    rng = np.random.default_rng(0)
    delays = np.where(nbrs >= 0, rng.integers(1, 4, nbrs.shape),
                      1).astype(np.int32)
    group = rng.integers(0, 2, (1, n)).astype(np.int8)

    def sim(dev):
        kw = dict(n_values=nv, sync_every=4, srv_ledger=False, device=dev)
        if mode == "partitions":
            kw["parts"] = broadcast.Partitions.from_numpy([2], [7], group)
        else:
            kw["fault_plan"] = spec.compile(dev)
        if mode == "delays_plan":
            kw["delays"] = delays
        return broadcast.BroadcastSim(nbrs, **kw)

    from gossip_glomers_tpu_torch.tpu_sim import provenance

    psp = provenance.ProvenanceSpec("broadcast")
    inject = broadcast.make_inject(n, nv)
    finals = []
    for dev in (cuda_device, "cpu"):
        s = sim(dev)
        with monkeypatch.context() as m:
            if dev != "cpu":
                m.setattr(kernels, "prov_attribute_plain", refuse)
            before = kernels.LAUNCHES["prov_attribute"]
            st, prov = s.run_observed(s.init_state(inject), None, None,
                                      rounds, donate=True,
                                      prov=s.provenance_state(psp, inject),
                                      prov_spec=psp)
            if dev != "cpu":
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["prov_attribute"] == before + rounds
        finals.append((s.received_node_major(st), int(st.msgs),
                       [x.cpu() for x in prov]))
    (ga, gm, gp), (ca, cm, cp) = finals
    np.testing.assert_array_equal(ga, ca)
    assert gm == cm
    assert all(torch.equal(x, y) for x, y in zip(gp, cp))
    assert int((gp[0] > 0).sum()) > 0


# -- the txn round's kernels (txn_round.cu) -------------------------------

# (nodes, ops a txn, keys, wrap): a single node and key, a ragged warp with
# colliding wrapped priorities, odd block tails, a power of two
TXN_CUDA_SHAPES = [(1, 1, 1, False), (31, 2, 5, True), (257, 4, 40, True),
                   (1000, 3, 977, False), (4097, 8, 3, True),
                   (2048, 2, 512, False)]


def _txn_case(n, o, k, wrap, seed, device):
    """A txn round's operands: random keys (not distinct), cur in [0, T],
    first attempts at a quarter of the nodes, issue stamps past the
    int32 wrap with ``wrap`` (two nodes then planted to share a wrapped
    priority and their keys at an odd n), random store rows and
    records."""
    rng = np.random.default_rng(seed)
    t_dim = 3
    keys = rng.integers(0, k, (n, t_dim, o)).astype(np.int32)
    cur = rng.integers(0, t_dim + 1, n).astype(np.int32)
    lo = -(-(1 << 31) // n) if wrap and n > 1 else 0
    issue = rng.integers(lo, (1 << 31) - 1 if wrap and n > 1 else 64, n)
    issue = np.where(rng.random(n) < 0.25, -1, issue).astype(np.int32)
    active = rng.random(n) < 0.6
    if wrap and n % 2 and n > 1:
        inv = pow(n, -1, 1 << 32)
        for j in range(64):
            ia, ib = ((((1 << 31) + j - x) * inv) % (1 << 32)
                      for x in (0, 1))
            if ia < 1 << 31 and ib < 1 << 31:
                issue[0], issue[1] = ia, ib
                cur[0] = cur[1] = 0
                keys[1, 0] = keys[0, 0]
                active[:2] = True
                break
    cap = -(-k // n) + 1

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    ints = lambda shape: rng.integers(-(1 << 31), 1 << 31,  # noqa: E731
                                      shape).astype(np.int32)
    return dict(keys=put(keys), write=put(rng.random((n, t_dim, o)) < 0.5),
                wval=put(ints((n, t_dim, o))), cur=put(cur),
                issue=put(issue), active=put(active),
                owner=put(rng.integers(0, n, k).astype(np.int64)),
                slot=put(rng.integers(0, cap, k).astype(np.int64)),
                vals=put(ints((n, cap))), vers=put(ints((n, cap))),
                op_ver=put(ints((n, t_dim, o))),
                op_val=put(ints((n, t_dim, o))),
                commit_round=put(ints((n, t_dim))),
                issue_round=put(ints((n, t_dim))),
                t=int(rng.integers(0, 1 << 20)), n_keys=k)


TXN_ARGS = ("keys", "write", "wval", "cur", "issue", "active", "owner",
            "slot", "vals", "vers", "op_ver", "op_val", "commit_round",
            "issue_round")
TXN_INPLACE = ("cur", "issue", "op_ver", "op_val", "commit_round",
               "issue_round")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TXN_CUDA_SHAPES)
def test_cuda_txn_kernels_match_plain(cuda_device, shape):
    c = _txn_case(*shape, sum(shape[:3]), cuda_device)
    before = dict(kernels.LAUNCHES)
    claim = (c["keys"], c["cur"], c["issue"], c["active"])
    best, att = kernels.txn_claim(*claim, t=c["t"], n_keys=c["n_keys"])
    best_p, att_p = kernels.txn_claim_plain(*claim, t=c["t"],
                                            n_keys=c["n_keys"])
    mine = {k: v.clone() if k in TXN_INPLACE else v for k, v in c.items()}
    req = kernels.txn_commit(best, *(mine[k] for k in TXN_ARGS), t=c["t"])
    want = kernels.txn_commit_plain(best_p, *(c[k] for k in TXN_ARGS),
                                    t=c["t"])
    torch.cuda.synchronize()
    assert torch.equal(best, best_p) and torch.equal(att, att_p)
    assert torch.equal(req, want[0])
    for name, w in zip(TXN_INPLACE, want[1:]):
        assert torch.equal(mine[name], w), name
    assert kernels.LAUNCHES["txn_claim"] == before["txn_claim"] + 1
    assert kernels.LAUNCHES["txn_commit"] == before["txn_commit"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("amnesia", (False, True))
def test_cuda_txn_round_equals_cpu_round(cuda_device, amnesia, monkeypatch):
    # every CUDA round runs the two kernels, never their plain versions,
    # makes no host sync, and lands the CPU round's state bit for bit
    from gossip_glomers_tpu_torch.tpu_sim import txn

    def refuse(*args, **kw):
        raise AssertionError("a plain txn kernel ran on a CUDA round")

    n, k, rounds = 509, 97, 40
    spec = faults.NemesisSpec(n_nodes=n, seed=4, crash=((3, 7, (1, 200)),),
                              loss_rate=0.15, loss_until=9)
    sims = [txn.TxnSim(n, k, txns_per_node=5, ops_per_txn=3, rate=0.6,
                       until=12, fault_plan=spec.compile(dev),
                       kv_amnesia=amnesia, workload_seed=2, device=dev)
            for dev in (cuda_device, "cpu")]
    with monkeypatch.context() as m:
        m.setattr(kernels, "txn_claim_plain", refuse)
        m.setattr(kernels, "txn_commit_plain", refuse)
        before = kernels.LAUNCHES["txn_commit"]
        g = sims[0].init_state()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            g = sims[0].run_fused(g, rounds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["txn_commit"] == before + rounds
    c = sims[1].run(sims[1].init_state(), rounds)
    assert g.t == c.t and int(g.msgs) == int(c.msgs)
    for f in ("arrived", "cur", "issue", "issue_round", "commit_round",
              "op_ver", "op_val"):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    assert torch.equal(g.rows.vals.cpu(), c.rows.vals)
    assert torch.equal(g.rows.vers.cpu(), c.rows.vers)
    assert txn.history_of(g, sims[0].ops) == txn.history_of(c, sims[1].ops)
    assert int((c.commit_round >= 0).sum()) > 0


# -- the scenario batch: the batched fault kernels and the folded round ---

# (S, N) pairs of kernel_check: one scenario, a few, a fuzz batch; rows a
# scenario 1 (every row its own scenario), 24 (blocks of the W = 1 and
# W = 2 rounds straddle scenarios) and 1,024
BATCH_SN = [(s, n) for s in (1, 3, 128) for n in (1, 24, 1024)]


def _batch_case(s, n, w, d, seed, device):
    """A folded (S N, D) table (-1 pads kept), its per-scenario (N, D)
    tables, an (S N,) up vector, a live mask, a coin table mixing every
    loss / dup stream state, payload, dup rows and receivers."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(-1, n, (s, n, d)).astype(np.int32)
    off = (np.arange(s) * n)[:, None, None]
    fold = np.where(nb >= 0, nb + off, -1).reshape(s * n, d).astype(np.int32)
    tab = np.stack([rng.integers(0, 2**32, s), rng.integers(0, 2**32, s) // 3,
                    rng.integers(0, 2**32, s) // 4, np.arange(s) % 2,
                    (np.arange(s) // 2) % 2], axis=1).astype(np.int64)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(fold=dev(fold), nb=dev(nb), up=dev(rng.random(s * n) >= 0.1),
                live=dev((rng.random((s * n, d)) < 0.7) & (fold >= 0)),
                table=dev(tab), payload=_bits((s * n, w), seed, device),
                received=_bits((s * n, w), seed + 1, device),
                rec=_bits((s * n, w), seed + 2, device))


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", BATCH_SN)
@pytest.mark.parametrize("w,d", [(1, 4), (2, 3), (64, 4)])
def test_cuda_batched_fault_kernels_match_plain(cuda_device, s, n, w, d):
    c = _batch_case(s, n, w, d, s * 1000 + n + w, cuda_device)
    before = dict(kernels.LAUNCHES)
    calls = 0
    for masked in (False, True):
        for out_ok in (False, True):
            kw = dict(t=9, out_ok=out_ok, table=c["table"], block=n,
                      live=c["live"] if masked else None)
            flags = kernels.fault_coins(c["fold"], c["up"], **kw)
            want = kernels.fault_coins_plain(c["fold"], c["up"], **kw)
            assert torch.equal(flags, want)
            for dup in (False, True):
                got = kernels.faulted_gather_round(
                    c["payload"], c["received"] if dup else None, c["rec"],
                    c["fold"], flags, block=n)
                ref = kernels.faulted_gather_round_plain(
                    c["payload"], c["received"] if dup else None, c["rec"],
                    c["fold"], flags, block=n)
                for a, b in zip(got, ref):
                    assert torch.equal(a, b)
                calls += 1
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fault_coins_batched"] \
        == before["fault_coins_batched"] + 4
    assert kernels.LAUNCHES["faulted_gather_round_batched"] \
        == before["faulted_gather_round_batched"] + calls
    if s == 1:
        # one scenario: the batched forms are the one-scenario kernels
        t = c["table"][0].tolist()
        one = kernels.fault_coins(
            c["nb"][0], c["up"], t=9, seed=t[0], loss_num=t[1],
            dup_num=t[2], loss=bool(t[3]), dup=bool(t[4]), out_ok=True)
        flags = kernels.fault_coins(c["fold"], c["up"], t=9, out_ok=True,
                                    table=c["table"], block=n)
        assert torch.equal(one, flags)
        a = kernels.faulted_gather_round(c["payload"], c["received"],
                                         c["rec"], c["fold"], flags)
        b = kernels.faulted_gather_round(c["payload"], c["received"],
                                         c["rec"], c["fold"], flags, block=n)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert int(a[2]) == int(b[2][0])


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", BATCH_SN)
@pytest.mark.parametrize("w", (1, 3, 64))
def test_cuda_fold_freeze_matches_plain(cuda_device, s, n, w):
    c = _batch_case(s, n, w, 2, s + n + w, cuda_device)
    active = torch.from_numpy(np.random.default_rng(w).random(s) < 0.5).to(
        cuda_device)
    before = kernels.LAUNCHES["fold_freeze"]
    got = (c["rec"].clone(), c["payload"].clone())
    want = (c["rec"].clone(), c["payload"].clone())
    kernels.fold_freeze(got[0], c["received"], active, n, got[1],
                        c["rec"])
    kernels.fold_freeze_plain(want[0], c["received"], active, n, want[1],
                              c["rec"])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES["fold_freeze"] == before + 1


@pytest.mark.cuda
def test_cuda_folded_batch_matches_sequential_and_cpu(cuda_device):
    # a small folded broadcast batch (partitions, delays, dup) on the card:
    # its rows, received sets and telemetry equal the CPU batch's and each
    # scenario's run_broadcast_nemesis on the card; the trip makes no host
    # sync and runs the batched kernels, never the one-scenario ones
    from gossip_glomers_tpu_torch.harness import nemesis
    from gossip_glomers_tpu_torch.tpu_sim import scenario, telemetry

    n, nv, s = 24, 48, 6
    nbrs = topology.to_padded_neighbors(topology.grid(n))
    rng = np.random.default_rng(1)
    cells = []
    for i in range(s):
        spec = faults.random_spec(n, seed=i + 1, horizon=8,
                                  n_crash_windows=i % 3,
                                  loss_rate=0.1 * (i % 2),
                                  dup_rate=0.05 * (i % 3 == 0))
        parts = ({"starts": [2], "ends": [5],
                  "group": [(np.arange(n) % 2).tolist()]} if i % 2 else None)
        cells.append(scenario.Scenario(
            spec=spec, parts=parts,
            delays=tuple(map(tuple, rng.integers(1, 3, nbrs.shape).tolist()))))
    for delayed in (True, False):
        scs = tuple(cells if delayed else
                    [scenario.Scenario(spec=c.spec, parts=c.parts)
                     for c in cells])
        batch = scenario.ScenarioBatch(
            workload="broadcast", scenarios=scs,
            runner_kw={"n_values": nv, "topology": "grid"},
            max_recovery_rounds=32)
        tel = telemetry.TelemetrySpec("broadcast", rounds=40)
        staged = scenario.stage_broadcast_batch(
            batch, telemetry_spec=tel, device=cuda_device)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = scenario.broadcast_trip(staged)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        handle["n_real"] = s
        got = scenario.collect_scenario_batch(handle)
        assert kernels.LAUNCHES["fault_coins"] == before["fault_coins"]
        assert kernels.LAUNCHES["fold_freeze"] > before["fold_freeze"]
        assert kernels.LAUNCHES["fault_coins_batched"] > \
            before["fault_coins_batched"]
        want = scenario.run_scenario_batch(batch, telemetry_spec=tel,
                                           device="cpu")
        assert got["scenarios"] == want["scenarios"]
        assert got["telemetry"] == want["telemetry"]
        assert torch.equal(got["final"].received.cpu(),
                           want["final"].received)
        for i, sc in enumerate(scs):
            seq = nemesis.run_broadcast_nemesis(
                sc.spec, n_values=nv, max_recovery_rounds=32,
                parts=sc.parts,
                delays=None if sc.delays is None else np.asarray(sc.delays),
                device=cuda_device)
            for k in ("converged_round", "msgs_total", "lost_writes", "ok"):
                assert got["scenarios"][i][k] == seq[k], (i, k)


# -- checkpoints, elastic resize and the fuzzer on the card ---------------


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path):
    # a CUDA state's save and restore: every field back on the card, in
    # the port's dtype, equal to the saved one; the same file on the CPU
    from gossip_glomers_tpu_torch.tpu_sim import checkpoint

    spec = faults.NemesisSpec(n_nodes=64, seed=3, crash=((2, 6, (1, 9)),),
                              loss_rate=0.1, loss_until=7)
    n = 64
    nbrs = topology.to_padded_neighbors(topology.tree(n))
    sims = {
        "tree_wm": broadcast.BroadcastSim(
            nbrs, n_values=40, sync_every=4, srv_ledger=False,
            exchange=structured.make_exchange("tree", n),
            fault_plan=spec.compile(cuda_device), device=cuda_device,
            nemesis=structured.make_nemesis("tree", n, spec,
                                            dir_delays=(1, 3),
                                            device=cuda_device)),
        "gather_ring": broadcast.BroadcastSim(
            nbrs, n_values=40, sync_every=4, device=cuda_device,
            delays=np.full(nbrs.shape, 2, np.int32))}
    for name, sim in sims.items():
        st = sim.init_state(broadcast.make_inject(n, 40))
        for _ in range(4):
            st = sim.step(st)
        path = str(tmp_path / f"{name}.npz")
        checkpoint.save(path, st, {"name": name}, fault_spec=spec)
        back, meta = checkpoint.restore(path, broadcast.BroadcastState)
        cpu, _ = checkpoint.restore(path, broadcast.BroadcastState,
                                    device="cpu")
        assert meta["name"] == name and back.t == st.t == cpu.t
        assert checkpoint.fault_spec_from_meta(meta).to_meta() == \
            spec.to_meta()
        for f in ("received", "frontier", "msgs", "history"):
            a, b = getattr(st, f), getattr(back, f)
            assert b.device.type == "cuda" and b.dtype == a.dtype, f
            assert torch.equal(a, b), f
            assert torch.equal(a.cpu(), getattr(cpu, f)), f
        # resumed on the card, equal to the uninterrupted run
        for _ in range(6):
            st, back = sim.step(st), sim.step(back)
        assert torch.equal(st.received, back.received)
    sim = counter.CounterSim(n, mode="allreduce", device=cuda_device,
                             fault_plan=spec.compile(cuda_device))
    st = sim.run(sim.add(sim.init_state(), np.arange(n, dtype=np.int32)), 3)
    checkpoint.save(str(tmp_path / "c.npz"), st)
    back, _ = checkpoint.restore(str(tmp_path / "c.npz"),
                                 counter.CounterState)
    for f in ("pending", "cached", "kv", "msgs"):
        assert torch.equal(getattr(st, f), getattr(back, f)), f


RESIZE_CUDA = {
    "broadcast_grow": ("broadcast", dict(n_nodes=64, seed=3,
                                         crash=((4, 9, (1, 2)),)), 96, 6,
                       dict(kv_keys=4096, max_recovery_rounds=48)),
    "broadcast_shrink": ("broadcast", dict(
        n_nodes=96, seed=5, crash=((4, 9, (1,)),),
        leave=((3, tuple(range(64, 96))),)), 64, 6,
        dict(kv_keys=4096, max_recovery_rounds=48)),
    "counter_grow": ("counter", dict(n_nodes=1024, seed=3,
                                     crash=((10, 15, (1, 2)),)), 2048, 12,
                     dict(mode="allreduce", kv_keys=8192,
                          max_recovery_rounds=48)),
    "counter_shrink": ("counter", dict(
        n_nodes=2048, seed=5, crash=((16, 21, (1,)),),
        leave=((8, tuple(range(1024, 2048))),)), 1024, 18,
        dict(mode="allreduce", max_recovery_rounds=48)),
    "kafka_grow": ("kafka", dict(n_nodes=64, seed=7,
                                 crash=((4, 9, (1, 2)),)), 96, 6,
                   dict(n_keys=16, max_recovery_rounds=48)),
    "kafka_shrink": ("kafka", dict(
        n_nodes=96, seed=9, crash=((4, 9, (1,)),),
        leave=((3, tuple(range(64, 96))),)), 64, 6,
        dict(n_keys=16, max_recovery_rounds=48)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RESIZE_CUDA))
def test_cuda_resize_campaign_equals_cpu(cuda_device, name):
    # one grow and one shrink campaign a workload on the card, its result
    # (no wall-clock field) equal to the port's CPU run
    from gossip_glomers_tpu_torch.harness import membership

    wl, kw, n_to, r, ckw = RESIZE_CUDA[name]
    spec = faults.NemesisSpec(**kw)
    before = dict(kernels.LAUNCHES)
    got = membership.run_resize_campaign(wl, spec, n_to, r,
                                         device=cuda_device, **ckw)
    want = membership.run_resize_campaign(wl, spec, n_to, r, device="cpu",
                                          **ckw)
    assert got == want
    assert got["ok"], got
    expect = {"broadcast": "faulted_gather_round", "counter":
              "counter_select", "kafka": "kafka_merge"}[wl]
    assert kernels.LAUNCHES[expect] > before[expect]


@pytest.mark.cuda
def test_cuda_fuzz_run_equals_cpu(cuda_device, tmp_path):
    # a 24-scenario fuzz campaign (delays on alternate batches, a planted
    # failure shrunk) on the card: rows, shrinks and coverage the CPU's
    from gossip_glomers_tpu_torch.harness import fuzz

    kw = dict(n_scenarios=24, n_nodes=12, batch_size=8, horizon=6,
              max_recovery_rounds=16, seed=7, plant_failure=True,
              max_shrinks=1, signatures=True)
    wall = ("batch_walls_s", "sample_s", "dispatch_s", "total_s",
            "scenarios_per_sec", "scenarios_per_sec_steady")

    def strip(res):
        out = {k: v for k, v in res.items() if k not in wall}
        out["shrinks"] = [{k: v for k, v in s.items() if k != "bundle"}
                          for s in res["shrinks"]]
        return out

    got = fuzz.fuzz_run("broadcast", device=cuda_device,
                        observe_dir=str(tmp_path / "g"), **kw)
    want = fuzz.fuzz_run("broadcast", device="cpu",
                         observe_dir=str(tmp_path / "c"), **kw)
    assert strip(got) == strip(want)
    assert got["n_failing"] >= 1 and got["shrinks"][0]["replay_same_failure"]
