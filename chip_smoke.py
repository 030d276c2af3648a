#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gossip_glomers_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); it builds the port's kernels
from ``gossip_glomers_tpu_torch/csrc/`` into ``build/`` (one ``nvcc`` per
source, all started together) and drives the main path, the broadcast
flood at 1,048,576 nodes, on every topology the port runs, then the
g-counter, unique ids and echo:

1. ``build``: nvcc build of the kernels, with its seconds.
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0: bitsets and counts), at small shapes
   and at the main path's shapes — the shift kernels in every mode
   (circulant, ring, line, grid with a ragged last row), also at rows one
   node short of, at, one over and two and a bit times their tile, and
   on views that start 4 bytes into their allocation; the gather
   kernels (``gather_or``, the fused ``gather_flood_round``,
   ``sync_diff_pc``) with and without an edge mask over -1-padded
   tables, at their block edges, at degrees 1, 3 and 8, with more and
   fewer payload rows than nodes and on 4-byte-offset views of every
   operand; the fault kernels (``fault_coins``, ``faulted_gather_round``)
   with every loss/dup stream combination, with and without a partition
   mask, on whole tables and on slabs of rows off the block grid, on
   4-byte-offset views, at the same edges and at (2^20, 1) and (2^20,
   128); the masked structured exchanges (``tree_masked_exchange``,
   ``shift_masked_exchange`` in every shift mode) under all-live,
   none-live and random packed rows, on 4-byte-offset views, at the small
   shapes, the shift kernels' tile edges, (1, 2^20) and (128, 2^20); the
   words-major coins (``wm_fault_coins``, every stream and the ledger
   mode) on every structured topology's id descriptors (the tree at
   branchings 1, 2, 3, 4 and 32 in both contracts, a ragged grid, ring,
   line, circulant) at every n of those shapes; ``tree_exchange`` also
   at n % 4 in {0, 1, 2, 3}, k = 4 and 3, W = 1 and 128, on 4-byte-offset
   views; the ring kernels (``tree_ring_exchange``,
   ``shift_ring_exchange``) on random 3-slot rings and rows, over every
   table shape the delay modes build (the tree's, every shift mode's as
   two delay classes and up to 24 rows, rows dropped), at the small
   shapes, n % 4 in {0, 1, 2, 3} (the tree's four nodes a thread and a
   node a thread), the main shapes and 4-byte-offset views; the counter
   round's kernels (``counter_select``, ``counter_apply``) at 1, 31,
   2^20 + 3 and 2^24 nodes in every layout (cas packed and wide,
   allreduce), with and without the gate byte, on poll and other
   rounds, with and without the stale coin, on 4-byte-offset views and
   in place — and each
   one's median
   time at the main path's shapes (the
   masked exchanges at both, on the tree's 2 rows and the circulant's 8,
   the masked shift kernel also at smaller tile caps; the coins on the
   tree nemesis's 2 delivery rows and the accounted circulant's 8 ledger
   rows at round 5; the ring kernels on the delay phases' edge-delayed
   tables at round 5, beside the composition of masked exchanges they
   replace; the counter kernels at config3c's 2^24, cas and wide, and
   config3b's 2^20, allreduce under its gate), with its bound and the share of it reached
   (``bound_share`` = bound / device time).  Bounds count each input
   read once and each output written once over 3.35 TB/s, and the
   integer operations the function needs at 64 lanes a clock an SM (the
   coins': :func:`coin_ops`, from the coins the call draws).
3. ``w1_tree``: the 4-ary tree with 32 values (W = 1 word per node), the
   fixed-trip flood to ``discover_rounds`` timed with CUDA events, then
   the accounted while-converge run with the server ledger on; both held
   against the port's plain CPU path at the same size.
4. ``w128_tree``: 4,096 values (W = 128), the fixed-trip flood timed the
   same way; its unwrapped closed-form ledger ``msgs64``; a CPU
   cross-check of the same path at 65,536 nodes.
5. ``w1_circulant``: the degree-8 circulant expander
   (``expander_strides(2^20, 8, seed=0)``) with 32 values, timed and
   accounted as ``w1_tree``; held against the CPU path and against the
   node-major gather path on ``circulant(n, strides)`` on the card.
6. ``w128_circulant``: the same expander at 4,096 values, timed, with
   ``msgs64`` and a CPU cross-check at 65,536 nodes.
7. ``w1_random_regular``: ``random_regular(2^20, 8, seed=0)`` through the
   node-major gather, 32 values: rounds from a host-stepped run, the
   fixed-trip runner timed, then an accounted run (server ledger on,
   sync waves every 4 rounds) held against the CPU path.
8. ``w1_random_regular_partitioned``: the same graph under one half/half
   partition window over rounds [2, 24), sync waves every 16 rounds, the
   server ledger on, run to convergence and held against the CPU path.
9. ``w1_random_regular_nemesis``: the same graph under the full
   Maelstrom nemesis (benchmarks/fault_sweep.py's: a crash window over
   rounds [2, 12) of every 97th node, loss 0.1 and dup 0.05 until round
   13, seed 0), sync waves every 4 rounds, server ledger off, through the
   faulted gather round: run to convergence host-stepped (not before the
   faults clear), then the fixed-trip runner timed; held against the CPU
   path bit for bit.
10. ``w1_random_regular_nemesis_accounted``: crash + loss (no dup, so
    the server ledger is on) under the partitioned phase's window, sync
    waves every 16 rounds, run to convergence and held against the CPU
    path, ``srv_msgs`` included.
11. ``w1_circulant_partitioned``: benchmarks/run_all.py's ``config4c``
    on the structured path: the circulant expander under the partitioned
    phase's window and groups, sync waves every 16 rounds, through the
    masked shift exchange; run to convergence, the fixed trip timed, then
    the accounted run (server ledger on), held against the CPU path and
    the card's gather path on ``circulant(n, strides)`` under the same
    ``Partitions``.
12. ``w1_tree_nemesis``: the 4-ary tree under
    benchmarks/fault_sweep.py's structured plan (every 97th node down over
    rounds [2, 16), loss 0.1 and dup 0.05 until round 17, seed 5), sync
    waves every 8 rounds, server ledger off, through the masked tree
    exchange and the words-major coins; run to convergence host-stepped
    (not before the faults clear), then the fixed trip timed, with its
    kernel launches a round; held against the CPU path and the card's
    gather path on ``to_padded_neighbors(tree(n))`` under the same plan.
13. ``w1_circulant_nemesis_accounted``: a loss-only plan (loss 0.1 until
    13, seed 0) composed with ``config4c``'s window on the structured
    circulant, sync waves every 16 rounds, server ledger on; held against
    the CPU path and the card's gather path, ``srv_msgs`` included.
14. ``w1_circulant_delayed``: benchmarks/run_all.py's ``config4d``
    itself: the circulant expander, 32 values, per-edge delays of 1 or 3
    rounds (``default_rng(11)``, p = 0.7 / 0.3), three ways — the gather
    ring over ``gather_delays_from_rows``, per-direction classes
    (``make_delayed``, the generator's next draw) and per-edge delays on
    the structured path (``make_edge_delayed``, 16 ring-table rows) —
    each host-stepped, its fixed trip timed; the edge-delayed run equals
    the gather ring, also accounted (server ledger on, sync waves every
    16 rounds); every way held against the CPU path.
15. ``w1_circulant_edge_delayed_partitioned``: the same delays under
    ``config4c``'s window and groups, sync waves every 16 rounds, through
    ``make_edge_delayed_faulted``; equal to the gather ring under the
    same ``Partitions``, ``srv_msgs`` included.
16. ``w1_tree_edge_delayed``: the 4-ary tree with per-edge delays of the
    same law, equal to the gather ring on ``to_padded_neighbors(tree(n))``.
17. ``w1_tree_nemesis_delayed``: ``w1_tree_nemesis``'s plan with
    ``dir_delays = (1, 3)``, equal to the gather ring with
    ``gather_delays_for`` under the same plan.
18. ``small_floods``: grid (65,536 nodes), ring and line (4,099 nodes)
    run to convergence with the server ledger on, each held against the
    CPU path (coverage, not timing).
19. ``counter_1m_partitioned``: benchmarks/run_all.py's ``config3b``
    (``_counter_bench`` at 2^20 nodes: allreduce, half the nodes off the
    KV for rounds [0, 8) of 16); ``ok``: the KV and every read equal the
    sum of the deltas.
20. ``counter_16m_cas_wide``: ``config3c`` (2^24 nodes, cas, the wide
    winner layout, 16 rounds); ``ok``: the KV equals the drained deltas
    and 16 nodes drained; ``run_fused`` equals ``run``.
21. ``counter_nemesis_device_kv``: benchmarks/fault_sweep.py's large-N
    counter plan at 2^17 nodes over the device KV: allreduce with the
    fault gate in ``union_block`` slabs and ``kv_amnesia``, to
    convergence, then cas with seq-kv stale reads for 32 rounds; ``ok``:
    the KV plus what is pending plus the deltas lost in amnesia rows is
    the acknowledged sum, the store holds the KV, allreduce converges.
22. ``ids_echo``: ``UniqueIdsSim`` at 2^20 nodes, 32 ids a node, 4
    rounds, every id distinct; ``EchoSim`` at (2^20, 4), ``msgs == 2
    valid``.

The counter phases are timed as fixed trips of ``run`` (CUDA events),
with their device busy time, idle share and port launches a round, and
each equals the port's CPU path in ``pending``, ``cached``, ``kv``,
``t``, ``msgs`` and the KV rows.

Device times (``device_ms``, ``device_busy_ms``) come from
torch.profiler and count only when it saw every port kernel launch of
the profiled run; after three incomplete profiles they are null (not
measured), and stderr says what each profile missed.  A kernel's
``device_ms`` averages only the spans of its own ``__global__``
(``kernel_ms``): a wrapper may launch helpers beside it (sync_diff_pc's
zero fill and casts).

Each phase prints one JSON line, after a ``card`` line (the card's name,
power limit, SM clock and the integer rate it gives); the kernels'
timing adds a ``ring_plan`` line at each main shape (the shift ring
plan's tile, stages, stage bytes and windows, and its L2-delivery
floor: windows x slot bytes at L2_BYTES_PER_S, a constant of an earlier
probe, not a measurement of this run).  Kernel launch
counts are zeroed just before each main-path phase and read just after.
Then come the card's name and power limit (``nvidia-smi``), one
``{"kernels": [...]}`` line
(the shift kernels' launches also split by path: the 1M-node floods at
W = 128 and at W = 1, and the small floods; ``gather_or`` launches on
the delay phases' gather ring) and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script
then exits non-zero and prints no result.  Without a CUDA card it exits
with status 2.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

N_NODES = 1 << 20
BRANCHING = 4
DEGREE = 8
W1_VALUES = 32
W128_VALUES = 4096
CHECK_NODES = 1 << 16        # the W = 128 CPU cross-check size
CHECK_SHAPES = [(w, n) for w in (1, 8, 32, 128)
                for n in (1, 5, 4097, (1 << 16) + 3)]
MAIN_SHAPES = [(1, N_NODES), (W128_VALUES // 32, N_NODES)]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# 32-bit integer add, multiply-add, shift, compare and logical operations
# a clock on one SM of compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput); main() sets OPS_PER_S to
# this x the SMs x the SM clock read from nvidia-smi (clocks.max.sm)
INT_LANES_PER_CLOCK = 64
OPS_PER_S: float | None = None
CSRC = "gossip_glomers_tpu_torch/csrc/"
JAX_PKG = "gossip_glomers_tpu/tpu_sim/"
# per kernel: (source, what it replaces — the fused 4-ary tree inbox Pallas
# kernel, never lowered by Mosaic, or the XLA code of the reference — and
# the name of its __global__, which the profiler reports)
KERNELS = {
    "tree_exchange": ("tree_flood.cu", "benchmarks/pallas_tree_probe.py:74",
                      "tree_exchange_kernel"),
    "tree_masked_exchange": ("tree_flood.cu", JAX_PKG + "structured.py:662",
                             "tree_masked_exchange_kernel"),
    "tree_flood_round": ("tree_flood.cu",
                         "benchmarks/pallas_tree_probe.py:74",
                         "tree_flood_round_kernel"),
    "col_popcount": ("tree_flood.cu", JAX_PKG + "broadcast.py:305",
                     "col_popcount_kernel"),
    "col_popcount_nm": ("gather_flood.cu", JAX_PKG + "broadcast.py:464",
                        "col_popcount_nm_kernel"),
    "shift_exchange": ("shift_flood.cu", JAX_PKG + "structured.py:170",
                       "shift_tiles_kernel"),
    "shift_flood_round": ("shift_flood.cu", JAX_PKG + "broadcast.py:288",
                          "shift_tiles_kernel"),
    "shift_masked_exchange": ("shift_flood.cu", JAX_PKG + "structured.py:688",
                              "shift_tiles_kernel"),
    "gather_or": ("gather_flood.cu", JAX_PKG + "broadcast.py:185",
                  "gather_or_kernel"),
    "sync_diff_pc": ("gather_flood.cu", JAX_PKG + "broadcast.py:247",
                     "sync_diff_pc_kernel"),
    "gather_flood_round": ("gather_flood.cu", JAX_PKG + "broadcast.py:579",
                           "gather_flood_round_kernel"),
    "fault_coins": ("fault_flood.cu", JAX_PKG + "broadcast.py:162",
                    "fault_coins_kernel"),
    "faulted_gather_round": ("fault_flood.cu", JAX_PKG + "broadcast.py:557",
                             "faulted_gather_round_kernel"),
    "wm_fault_coins": ("fault_flood.cu", JAX_PKG + "faults.py:690",
                       "wm_fault_coins_kernel"),
    "tree_ring_exchange": ("tree_flood.cu",
                           "benchmarks/pallas_tree_probe.py:74",
                           "tree_ring_exchange_kernel"),
    "shift_ring_exchange": ("shift_flood.cu", JAX_PKG + "structured.py:1038",
                            "shift_tiles_kernel"),
    "counter_select": ("counter_round.cu", JAX_PKG + "counter.py:397",
                       "counter_select_kernel"),
    "counter_apply": ("counter_round.cu", JAX_PKG + "counter.py:483",
                      "counter_apply_kernel"),
}
# the gather kernels' main shapes are node-major (N, W) = (2^20, 1) and
# (2^20, 128), degree 8
GATHER_SHAPES = [(1, N_NODES), (W128_VALUES // 32, N_NODES)]
# the profiler's names of the port's kernels (csrc/*.cu __global__s)
PORT_KERNEL = re.compile(r"(tree_exchange|tree_masked_exchange|"
                         r"tree_ring_exchange|"
                         r"tree_flood_round|col_popcount|col_popcount_nm|"
                         r"shift_tiles|gather_or|sync_diff_pc|"
                         r"gather_flood_round|fault_coins|"
                         r"faulted_gather_round|wm_fault_coins|"
                         r"counter_select|counter_apply)_kernel")
LEAD_IN_CYCLES = 2_000_000   # the profiler's lead-in spin, ~1 ms on an H100
# plan tile caps at which shift_masked_exchange is also timed (the
# wrapper's, kernels.SHIFT_TILE, first)
MASKED_TILES = (2048, 1024, 512)
# what the L2 delivered to the SMs in an L2 probe on an H100 (PERF.md)
L2_BYTES_PER_S = 5.33e12
# the H100 SXM's L2 (data sheet): operands below it stay there between
# back-to-back calls
L2_BYTES = 50 << 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, samples: int = 5, inner: int = 10) -> float:
    """Median over ``samples`` of the mean CUDA-event time of ``inner``
    back-to-back calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_spans(make_run, attempts: int = 3) -> list[dict] | None:
    """Device spans of one staged run, from torch.profiler's CUDA
    activity: ``[{"name", "us"}]`` for every kernel, copy and set it
    launched.  ``make_run()`` stages a run off the profiler and returns
    it as a zero-argument call.

    The profiler can drop kernels that run just after it starts (or
    all of a short run's), so each attempt stages two runs: the first
    runs in the warm-up step, whose events are dropped, the second in
    the active step behind a ~1 ms spin kernel, so that its first
    kernel starts well inside the recorded window.  An attempt counts
    only if the profiler saw every launch of the port's kernels that
    the wrappers counted in the measured run; after ``attempts``
    incomplete profiles the result is None (not measured)."""
    import torch
    from gossip_glomers_tpu_torch.tpu_sim import kernels
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, attempts + 1):
        runs = [make_run(), make_run()]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            runs[0]()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(LEAD_IN_CYCLES)
            before = sum(kernels.LAUNCHES.values())
            runs[1]()
            torch.cuda.synchronize()
            launched = sum(kernels.LAUNCHES.values()) - before
            prof.step()
        spans = [{"name": e.name, "us": e.time_range.end - e.time_range.start}
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        seen = sum(1 for s in spans if PORT_KERNEL.search(s["name"]))
        if spans and seen == launched:
            return spans
        print(f"chip_smoke: profile {attempt} of {attempts} saw {seen} of "
              f"{launched} port kernel launches ({len(spans)} device "
              "spans)", file=sys.stderr, flush=True)
    return None


def kernel_ms(spans: list[dict], kernel: str) -> float:
    """Mean time (ms) of the spans of the ``__global__`` named ``kernel``
    (a whole word of the span's name: ``col_popcount_kernel`` is not
    ``col_popcount_nm_kernel``); the other spans of the call — fills,
    casts, elementwise ops a wrapper launches beside its kernel — do not
    count.  Raises if the kernel has no span."""
    name = re.compile(rf"\b{re.escape(kernel)}\b")
    mine = [s["us"] for s in spans if name.search(s["name"])]
    if not mine:
        raise AssertionError(f"no device span of {kernel} among "
                             f"{sorted({s['name'] for s in spans})}")
    return sum(mine) / len(mine) / 1e3


def device_ms(fn, kernel: str, calls: int = 1) -> float | None:
    """Mean device time (ms) of one launch of the ``__global__`` named
    ``kernel`` during ``calls`` calls of ``fn`` (None: not measured)."""
    def staged():
        def run():
            for _ in range(calls):
                fn()
        return run

    spans = device_spans(staged)
    return None if spans is None else kernel_ms(spans, kernel)


def device_busy_ms(make_run) -> float | None:
    """Total device time (ms) of everything one staged run launched
    (None: not measured)."""
    return busy_and_spans(make_run)[0]


def busy_and_spans(make_run) -> tuple[float | None, int | None]:
    """(total device ms, device spans) of one staged run: every kernel,
    copy and set it launched (None, None: not measured)."""
    spans = device_spans(make_run)
    if spans is None:
        return None, None
    return sum(s["us"] for s in spans) / 1e3, len(spans)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def at_offset(x, offset: int):
    """A contiguous copy of x starting ``offset`` elements into its
    allocation (1 of int32: 4 bytes, off the 16-byte grid)."""
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def bound(moved_bytes: float, ops: float,
          bytes_per_s: float = HBM_BYTES_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") for work that moves
    ``moved_bytes`` (at ``bytes_per_s``: HBM's rate, or the L2's for
    operands that stay in it) and does ``ops`` integer operations (at
    the card's integer rate, :data:`OPS_PER_S`)."""
    by = moved_bytes / bytes_per_s * 1e3
    op = ops / OPS_PER_S * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


# the integer operations of wm_fault_coins' function (fault_flood.cu's
# hash): a loss coin is the two id products, their xor with the salted
# key, mix32's 8 and the compare; a dup coin shares the products (the
# salted key, mix32, the compare)
OPS_LOSS_COIN, OPS_DUP_COIN = 13, 10
# a closed-form id by its form (kernels.COIN_*): IDENT none; SHIFT an
# add, a subtract of n and an unsigned min; PARENT an add and a shift (k
# a power of two); CHILD a multiply-add
OPS_ID = (0, 3, 2, 1)
# a slot's live bit: its test and the AND with the slot's coins
OPS_LIVE_BIT = 2


def coin_ops(dirs, n: int, n_loss: int, n_dup: int) -> int:
    """Integer operations one ``wm_fault_coins`` call needs: each (row,
    node) slot's two closed-form ids (``dirs``' forms, :data:`OPS_ID`)
    and live bit, and the loss and dup coins it draws."""
    slot = sum(OPS_ID[int(src)] + OPS_ID[int(dst)] + OPS_LIVE_BIT
               for src, _, dst, _ in dirs.tolist())
    return slot * n + OPS_LOSS_COIN * n_loss + OPS_DUP_COIN * n_dup


def shift_edges(tile: int) -> list:
    """The shift kernels' edge shapes for their tile: a row one node
    short of a tile, one tile, one over, and a ragged third at W = 128
    (odd n)."""
    return [(1, tile - 1), (8, tile), (1, tile + 1), (128, 2 * tile + 3)]


def ragged_cols(n: int, grid_cols) -> int:
    """A grid width whose last row is ragged (for n > 2)."""
    return max(1, grid_cols(n) - 1)


def shift_modes(n: int, topology) -> list:
    """The shift kernels' modes at n nodes: (name, topology, kw)."""
    return [("circulant", "circulant",
             {"strides": topology.expander_strides(n, DEGREE, seed=0)}),
            ("ring", "ring", {}), ("line", "line", {}),
            ("grid", "grid", {"cols": ragged_cols(n, topology.grid_cols)})]


def gather_case(w: int, n: int, d: int, n_src: int, seed: int, device):
    """A gather case from ``seed``: an (n_src, W) payload, an (n, W) recv,
    an (n, d) table of indices in [-1, n_src + 3) (-1 pads, and indices
    past the payload, which the kernels clip) and an (n, d) edge mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nbrs = rng.integers(-1, n_src + 3, (n, d)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed)

    def bits(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=device, generator=gen)

    return (bits((n_src, w)), bits((n, w)), torch.from_numpy(nbrs).to(device),
            torch.from_numpy(rng.random((n, d)) < 0.7).to(device))


def gather_edges(nodes_per_block) -> list:
    """The gather kernels' edge shapes (w, n, d, n_src): at W = 1 and 128
    (degree 8) a block's nodes (``nodes_per_block(w)``) less one, one
    block's, one more, and two and a ragged third; then degrees 1 and 3,
    and payloads with more and fewer rows than nodes."""
    out = []
    for w in (1, 128):
        b = nodes_per_block(w)
        out += [(w, n, DEGREE, n) for n in (b - 1, b, b + 1, 2 * b + 3)]
    return out + [(1, 4097, 1, 4097), (8, 4097, 3, 4097),
                  (1, 4097, DEGREE, 5000), (32, 4097, DEGREE, 3000)]


def check_gather(kernels, note, payload, recv, nbrs, live,
                 offset: int = 0) -> None:
    """The three gather kernels against their plain versions on one case,
    with and without the mask; ``offset`` 1 moves every operand 4 bytes
    into its allocation."""
    views = (at_offset(payload, offset), at_offset(recv, offset),
             at_offset(nbrs, offset), at_offset(live, 4 * offset))
    for lv, lk in ((None, None), (live, views[3])):
        note("gather_or", (kernels.gather_or(views[0], views[2], lk),
                           kernels.gather_or_plain(payload, nbrs, lv)))
        note("sync_diff_pc", (
            kernels.sync_diff_pc(views[0], views[1], views[2], lk),
            kernels.sync_diff_pc_plain(payload, recv, nbrs, lv)))
        note("gather_flood_round", *zip(
            kernels.gather_flood_round(views[0], views[1], views[2], lk),
            kernels.gather_flood_round_plain(payload, recv, nbrs, lv)))


def gather_inputs(w: int, n: int, seed: int, device, topology):
    """Node-major payload and receiver bitsets, a -1-padded degree-8
    table and an edge mask, made from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nbrs = topology.random_regular(n, DEGREE, seed=seed)
    nbrs[rng.random(nbrs.shape) < 0.1] = -1
    gen = torch.Generator(device=device).manual_seed(seed)

    def bits(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=device, generator=gen)

    return (bits((n, w)), bits((n, w)), torch.from_numpy(nbrs).to(device),
            torch.from_numpy(rng.random(nbrs.shape) < 0.7).to(device))


# the fault coins' streams in the checks: (loss, dup) active, and the
# rates, round and seed their hashes take
FAULT_STREAMS = ((False, False), (True, False), (False, True), (True, True))
FAULT_COINS = {"t": 7, "seed": 0x9E3779B9 ^ 12345,
               "loss_num": int(0.3 * 2**32), "dup_num": int(0.2 * 2**32)}


def fault_case(w: int, n: int, d: int, n_src: int, seed: int, device):
    """A fault-kernel case from ``seed``: :func:`gather_case`'s operands
    (payload, recv, nbrs, live) and an (n_src, W) received set whose rows
    the dup edges read, an (n_src,) up vector with a tenth of the nodes
    down."""
    import numpy as np
    import torch

    payload, rec, nbrs, live = gather_case(w, n, d, n_src, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    received = torch.randint(-(1 << 31), 1 << 31, (n_src, w),
                             dtype=torch.int32, device=device, generator=gen)
    up = torch.from_numpy(
        np.random.default_rng(seed + 1).random(n_src) >= 0.1).to(device)
    return payload, received, rec, nbrs, live, up


def check_faults(kernels, note, case, lo: int = 0, hi: int | None = None,
                 offset: int = 0) -> None:
    """``fault_coins`` and ``faulted_gather_round`` against their plain
    versions on one case: every (loss, dup) stream combination, with and
    without the partition mask, over the destination rows [lo, hi) (the
    slab's views: rows of the table, node ids from ``lo``), with every
    operand ``offset`` words (4 bytes) into its allocation."""
    payload, received, rec, nbrs, live, up = case
    hi = nbrs.shape[0] if hi is None else hi
    nb, lv, rc = nbrs[lo:hi], live[lo:hi], rec[lo:hi]
    views = {name: at_offset(x, offset * (4 if x.element_size() == 1
                                          else 1))
             for name, x in (("nb", nb), ("lv", lv), ("rc", rc),
                             ("up", up), ("payload", payload),
                             ("received", received))}
    for loss, dup in FAULT_STREAMS:
        for masked in (False, True):
            kw = dict(FAULT_COINS, loss=loss, dup=dup, out_ok=True, row0=lo)
            flags = kernels.fault_coins(views["nb"], views["up"],
                                        live=views["lv"] if masked else None,
                                        **kw)
            want = kernels.fault_coins_plain(nb, up, live=lv if masked
                                             else None, **kw)
            note("fault_coins", (flags, want))
            fl = at_offset(want, 4 * offset)
            got = kernels.faulted_gather_round(
                views["payload"], views["received"] if dup else None,
                views["rc"], views["nb"], fl)
            note("faulted_gather_round", *zip(
                got, kernels.faulted_gather_round_plain(
                    payload, received if dup else None, rc, nb, want)))


ROW_MODES = ("all", "none", "random")


def packed_rows(kernels, d: int, n: int, mode: str, seed: int, device):
    """(d, ceil(n/32)) packed liveness rows: every node live, none, or
    random words (the bits past n random too: no kernel may read them)."""
    import torch

    if mode == "all":
        return kernels.pack_bits(torch.ones((d, n), dtype=torch.bool,
                                            device=device))
    if mode == "none":
        return torch.zeros((d, kernels.packed_words(n)), dtype=torch.int32,
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (d, kernels.packed_words(n)),
                         dtype=torch.int32, device=device, generator=gen)


WM_STREAMS = ((False, False, False), (True, False, False),
              (False, True, False), (True, True, False),
              (False, False, True), (True, False, True))
WM_COINS = {"t": 5, "seed": 5, "loss_num": int(0.3 * 2**32),
            "dup_num": int(0.2 * 2**32)}


def check_masked(kernels, structured, topology, note, fr, seed: int,
                 offset: int = 0) -> None:
    """The masked exchanges against their plain versions over one (W, N)
    payload ``fr``: every row mode, the tree's two rows apart, every shift
    mode, each operand ``offset`` words into its allocation."""
    w, n = fr.shape
    frk = at_offset(fr, offset)
    for mode in ROW_MODES:
        rows = packed_rows(kernels, 2, n, mode, seed, fr.device)
        rk = [at_offset(r, offset) for r in rows]
        note("tree_masked_exchange", (
            kernels.tree_masked_exchange(frk, rk[0], rk[1], BRANCHING),
            kernels.tree_masked_exchange_plain(fr, rows[0], rows[1],
                                               BRANCHING)))
        for _, topo, kw in shift_modes(n, topology):
            dirs = structured.shift_dirs(topo, n, **kw)
            live = packed_rows(kernels, len(dirs.offs), n, mode, seed + 1,
                               fr.device)
            note("shift_masked_exchange", (
                kernels.shift_masked_exchange(frk, at_offset(live, offset),
                                              dirs),
                kernels.shift_masked_exchange_plain(fr, live, dirs)))


# the tree's branchings in the coin checks (k + 1 words a warp at k = 3
# straddle, 32 a word a child in the masked exchange; 4 the main path's)
COIN_BRANCHINGS = (1, 2, 3, 4, 32)


def coin_dir_sets(structured, topology, n: int) -> list:
    """Every structured topology's coin descriptors at n nodes: (name,
    (D, 4) int64 numpy rows) for the tree at :data:`COIN_BRANCHINGS` in
    the delivery and the degree contract, a ragged grid, the ring, the
    line and the circulant expander."""
    out = [(f"tree{k}_{c}", structured.coin_dirs(
        "tree", n, degree=c == "deg", branching=k))
        for k in COIN_BRANCHINGS for c in ("del", "deg")]
    return out + [(name, structured.coin_dirs(topo, n, **kw))
                  for name, topo, kw in shift_modes(n, topology)]


def check_coins(kernels, structured, topology, note, n: int, seed: int,
                device, offset: int = 0) -> None:
    """``wm_fault_coins`` on every topology's descriptors
    (:func:`coin_dir_sets`) against ``wm_fault_coins_plain`` over their
    materialized id rows (``kernels.coin_dir_rows``, the kernel's uint32
    ids also where no edge exists, so that random rows compare): every
    row mode, every stream of :data:`WM_STREAMS` (loss, dup, the ledger
    mode), the live rows ``offset`` words into their allocation."""
    import torch

    for name, rows in coin_dir_sets(structured, topology, n):
        dirs = torch.from_numpy(rows).to(device)
        src, dst = kernels.coin_dir_rows(dirs, n)
        for mode in ROW_MODES:
            live = packed_rows(kernels, len(rows), n, mode, seed, device)
            lk = at_offset(live, offset)
            for loss, dup, srv in WM_STREAMS:
                kw = dict(WM_COINS, loss=loss, dup=dup, srv=srv)
                want = kernels.wm_fault_coins_plain(src, dst, live, **kw)
                got = kernels.wm_fault_coins(dirs, n, lk, **kw)
                note("wm_fault_coins", *(
                    (g, x) for g, x in zip(got, want) if x is not None))


# tree_exchange's vector-path cases: n % 4 in {0, 1, 2, 3} (a row of the
# four-nodes-a-thread path, then rows the scalar kernel takes), rows whose
# last quads' children stop at each vector, k = 4 and k = 3
TREE_VEC_NS = (4, 20, 44, 4096, 4097, 4098, 4099, 65552)


def check_tree(kernels, note, bits) -> None:
    """``tree_exchange`` against ``tree_exchange_plain`` at
    :data:`TREE_VEC_NS`, W = 1 and 128, k = 4 and 3, on views at offsets
    0 and 1 (4 bytes in: the scalar kernel)."""
    for n in TREE_VEC_NS:
        for w in (1, 128):
            fr = bits(w, n)
            for offset in (0, 1):
                view = at_offset(fr, offset)
                for k in (4, 3):
                    note("tree_exchange", (kernels.tree_exchange(view, k),
                                           kernels.tree_exchange_plain(fr,
                                                                       k)))


def ring_tree_tables(rng, slots: int, rows: int) -> list:
    """tree_ring_exchange's table shapes: make_delayed's two ungated
    terms, the nemesis's two gated ones, make_edge_delayed's 2 |V| (|V| =
    3), a 21-entry random table (two launches) and that table with the
    entries of slot 1 dropped (as a send round below 0 drops them)."""
    rand = [(int(rng.integers(0, slots)), int(rng.integers(0, 2)),
             int(rng.integers(-1, rows))) for _ in range(21)]
    return [[(0, 0, -1), (2, 1, -1)], [(1, 0, 0), (0, 1, 1)],
            [(v, kind, 2 * v + kind) for v in range(3) for kind in (0, 1)],
            rand, [e for e in rand if e[0] != 1]]


def check_ring(kernels, structured, topology, note, w: int, n: int,
               seed: int, device, offset: int = 0) -> None:
    """Both ring kernels against their twins on one random (3, W, N) ring
    and random packed rows: the tree's tables (:func:`ring_tree_tables`,
    k = 4 and 3: four nodes a thread on an aligned ring with n % 4 == 0,
    else a node a thread), every shift mode's directions at once, as two
    delay classes (slots 2 and 0: the edge-delayed table, a group a
    slot) and three times over (24 rows, one launch), with random slots,
    with and without rows, and with the rows of slot 1 dropped; ring and
    rows ``offset`` words into their allocation."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    ring = torch.randint(-(1 << 31), 1 << 31, (3, w, n), dtype=torch.int32,
                         device=device, generator=gen)
    live = torch.randint(-(1 << 31), 1 << 31, (48, kernels.packed_words(n)),
                         dtype=torch.int32, device=device, generator=gen)
    rk = at_offset(ring, offset)
    for k in (BRANCHING, 3):
        for table in ring_tree_tables(rng, 3, 6):
            note("tree_ring_exchange", (
                kernels.tree_ring_exchange(rk, table,
                                           at_offset(live[:6], offset), k),
                kernels.tree_ring_exchange_plain(ring, table, live[:6], k)))
    for _, topo, kw in shift_modes(n, topology):
        dirs = structured.shift_dirs(topo, n, **kw)
        for reps in (1, 2, 3):
            slots = (tuple(int(x) for x in
                           rng.integers(0, 3, len(dirs.offs) * reps))
                     if reps != 2 else
                     (2,) * len(dirs.offs) + (0,) * len(dirs.offs))
            keep = [d for d, x in enumerate(slots) if x != 1]
            for sel in (list(range(len(slots))), keep):
                table = kernels.ShiftDirs(
                    tuple((dirs.offs * reps)[d] for d in sel),
                    tuple((dirs.flags * reps)[d] for d in sel), dirs.cols,
                    tuple(slots[d] for d in sel))
                rows = live[:len(sel)]
                for lv in (None, rows):
                    note("shift_ring_exchange", (
                        kernels.shift_ring_exchange(
                            rk, table,
                            None if lv is None else at_offset(lv, offset)),
                        kernels.shift_ring_exchange_plain(ring, table, lv)))


# the ring kernels' shapes besides CHECK_SHAPES and MAIN_SHAPES: n % 4 in
# {0, 2} (CHECK_SHAPES' n hold 1 and 3); n % 4 == 0 takes the tree's four
# nodes a thread, also where no quad has all its children (n < 16)
RING_SHAPES = [(1, 4096), (8, 4098), (1, 12), (8, 20), (128, 4), (1, 65540)]


def check_kernels(kernels, structured, topology, device) -> dict:
    """Every kernel, in every mode, against its plain version on the card;
    returns the per-kernel max |kernel - plain| over all shapes (must be
    0)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)

    def bits(w, n):
        return torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                             device=device, generator=gen)

    err = {name: 0 for name in KERNELS}

    def note(name, *pairs):
        err[name] = max(err[name], *(max_abs_err(a, b) for a, b in pairs))

    def check_shift(rec, fr, n, offset=0):
        for _, topo, kw in shift_modes(n, topology):
            dirs = structured.shift_dirs(topo, n, **kw)
            note("shift_exchange", (kernels.shift_exchange(fr, dirs),
                                    kernels.shift_exchange_plain(fr, dirs)))
            rk = at_offset(rec, offset)
            nk = at_offset(torch.empty_like(fr), offset)
            kernels.shift_flood_round(rk, fr, nk, dirs)
            rp, np_ = rec.clone(), torch.empty_like(fr)
            kernels.shift_flood_round_plain(rp, fr, np_, dirs)
            note("shift_flood_round", (rk, rp), (nk, np_))

    for w, n in shift_edges(kernels.SHIFT_TILE):
        for offset in (0, 1):
            fr = bits(w, n)
            check_shift(at_offset(bits(w, n), offset),
                        at_offset(fr, offset), n, offset)
            check_masked(kernels, structured, topology, note, fr,
                         w + n + offset, offset)
    # the coins at every n of the shift edges and the shapes, once an n
    for n in sorted({n for _, n in shift_edges(kernels.SHIFT_TILE)
                     + CHECK_SHAPES + MAIN_SHAPES}):
        for offset in (0, 1):
            check_coins(kernels, structured, topology, note, n, n + offset,
                        device, offset)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    check_tree(kernels, note, bits)
    for w, n in CHECK_SHAPES + RING_SHAPES + MAIN_SHAPES:
        for offset in (0, 1):
            check_ring(kernels, structured, topology, note, w, n,
                       w + n + offset, device, offset)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    lib = kernels._lib("gather_flood")
    for w in (1, 3, 8, 32, 128, 256):
        if lib.gg_gather_nodes_per_block(w, 1) \
                != kernels.gather_nodes_per_block(w):
            raise AssertionError(f"gather geometry at W = {w}: the library "
                                 "and kernels.gather_nodes_per_block differ")
    flib = kernels._lib("fault_flood")
    for w in (1, 3, 8, 32, 128, 256):
        if flib.gg_faulted_nodes_per_block(w, 1) \
                != kernels.gather_nodes_per_block(w):
            raise AssertionError(f"faulted_gather_round's geometry at W = "
                                 f"{w} is not gather_nodes_per_block's")
    for w, n, d, n_src in gather_edges(kernels.gather_nodes_per_block):
        case = gather_case(w, n, d, n_src, n + d, device)
        for offset in (0, 1):
            check_gather(kernels, note, *case, offset=offset)
        # node ids index up: the faulted round's payload covers every node
        case = fault_case(w, n, d, max(n, n_src), n + d, device)
        b = kernels.gather_nodes_per_block(w)
        lo = min(b // 2 + 1, n - 1)           # a slab off the block grid
        for lo, hi, offset in ((0, n, 0), (0, n, 1),
                               (lo, max(n - 3, lo + 1), 1)):
            check_faults(kernels, note, case, lo, hi, offset)
    for w, n in CHECK_SHAPES + MAIN_SHAPES:
        rec, fr = bits(w, n), bits(w, n)
        note("tree_exchange", (kernels.tree_exchange(fr, BRANCHING),
                               kernels.tree_exchange_plain(fr, BRANCHING)))
        rk, nk = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round(rk, fr, nk, BRANCHING)
        rp, np_ = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round_plain(rp, fr, np_, BRANCHING)
        note("tree_flood_round", (rk, rp), (nk, np_))
        note("col_popcount", (kernels.col_popcount(rec),
                              kernels.col_popcount_plain(rec)))
        check_shift(rec, fr, n)
        if (w, n) in CHECK_SHAPES + MAIN_SHAPES:
            for offset in (0, 1):
                check_masked(kernels, structured, topology, note, fr,
                             w + n + offset, offset)
        del rec, fr, rk, nk, rp, np_
        payload, recv, nbrs, live = gather_inputs(w, n, n + w, device,
                                                  topology)
        check_gather(kernels, note, payload, recv, nbrs, live)
        note("col_popcount_nm", (
            kernels.col_popcount(payload, node_major=True),
            kernels.col_popcount_plain(payload, node_major=True)))
        del payload, recv, nbrs, live
        if (w, n) in GATHER_SHAPES:
            case = fault_case(w, n, DEGREE, n, n + w, device)
            check_faults(kernels, note, case)
            if w == 1:          # an unaligned slab of 4-byte-offset views
                check_faults(kernels, note, case, 1001, n - 77, 1)
            del case
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    check_counter(kernels, note, device)
    bad = {k: v for k, v in err.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"(tolerance 0): {bad}")
    return err


def nemesis_spec(faults, n: int, dup: bool):
    """Config 4b's full nemesis (benchmarks/fault_sweep.py's faulted-round
    spec at this phase's rounds): a crash window over rounds [2, 12) of
    every 97th node, loss 0.1 and, with ``dup``, dup 0.05 until round 13,
    seed 0."""
    kw = dict(n_nodes=n, seed=0, crash=((2, 12, tuple(range(0, n, 97))),),
              loss_rate=0.1, loss_until=13)
    if dup:
        kw.update(dup_rate=0.05, dup_until=13)
    return faults.NemesisSpec(**kw)


def tree_nemesis_spec(faults, n: int):
    """benchmarks/fault_sweep.py's structured plan (``_faulted_round_row``
    at 16 rounds): every 97th node down over rounds [2, 16), loss 0.1 and
    dup 0.05 until round 17, seed 5."""
    return faults.NemesisSpec(
        n_nodes=n, seed=5, crash=((2, 16, tuple(range(0, n, 97))),),
        loss_rate=0.1, loss_until=17, dup_rate=0.05, dup_until=17)


def loss_only_spec(faults, n: int):
    """The accounted circulant phase's loss-only plan: loss 0.1 until
    round 13, seed 0."""
    return faults.NemesisSpec(n_nodes=n, seed=0, loss_rate=0.1,
                              loss_until=13)


def config4c_parts(broadcast, n: int):
    """run_all.py config4c's schedule: one half/half window over rounds
    [2, 24), groups ``default_rng(7).integers(0, 2, n)``; returns
    (Partitions, (1, n) groups)."""
    import numpy as np

    group = np.random.default_rng(7).integers(0, 2, n).astype(
        np.int8)[None, :]
    return broadcast.Partitions.from_numpy([2], [24], group), group


def _timed(name, kern, plain, bound_ms_by) -> dict:
    b_ms, b_by = bound_ms_by
    dev_ms = device_ms(kern, KERNELS[name][2], calls=10)
    return {"ms": cuda_ms(kern), "device_ms": dev_ms,
            "plain_ms": cuda_ms(plain, inner=3), "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": None if dev_ms is None else b_ms / dev_ms}


def idle_share(busy_ms: float | None, wall_ms: float) -> float | None:
    return None if busy_ms is None else 1 - busy_ms / wall_ms


def time_kernels(kernels, structured, topology, device) -> dict:
    """{kernel: {(w, n): {ms, device_ms, plain_ms, bound_ms, bound_by}}}
    at the main path's shapes.  ``ms`` is the CUDA-event time of
    back-to-back calls (the host's launch path included), ``device_ms``
    the profiler's device time of one launch.  Bounds count each input
    read once and each output written once."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    k = BRANCHING
    out = {name: {} for name in KERNELS}
    for w, n in MAIN_SHAPES:
        rec = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                            device=device, generator=gen)
        fr = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                           device=device, generator=gen)
        nxt = torch.empty_like(fr)
        words = w * n
        dirs = structured.shift_dirs(
            "circulant", n,
            strides=topology.expander_strides(n, DEGREE, seed=0))
        n_dirs = len(dirs.offs)
        runs = {
            "tree_exchange": (
                lambda: kernels.tree_exchange(fr, k),
                lambda: kernels.tree_exchange_plain(fr, k),
                bound(2 * 4 * words, k * words)),
            # received is updated in place: every call does the same work
            "tree_flood_round": (
                lambda: kernels.tree_flood_round(rec, fr, nxt, k),
                lambda: kernels.tree_flood_round_plain(rec, fr, nxt, k),
                bound(4 * 4 * words, (k + 3) * words)),
            "col_popcount": (
                lambda: kernels.col_popcount(fr),
                lambda: kernels.col_popcount_plain(fr),
                bound(4 * words + 4 * n, 2 * words)),
            "shift_exchange": (
                lambda: kernels.shift_exchange(fr, dirs),
                lambda: kernels.shift_exchange_plain(fr, dirs),
                bound(2 * 4 * words, n_dirs * words)),
            "shift_flood_round": (
                lambda: kernels.shift_flood_round(rec, fr, nxt, dirs),
                lambda: kernels.shift_flood_round_plain(rec, fr, nxt, dirs),
                bound(4 * 4 * words, (n_dirs + 3) * words)),
        }
        for name, (kern, plain, b) in runs.items():
            out[name][(w, n)] = _timed(name, kern, plain, b)
        del rec, fr, nxt
        torch.cuda.empty_cache()
    # the gather kernels at the main path's node-major (2^20, W), degree
    # 8, fault-free (no edge mask: every index >= 0 delivers), keyed
    # (W, N) like the rest
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, faults

    nbrs = torch.from_numpy(topology.random_regular(N_NODES, DEGREE,
                                                    seed=0)).to(device)
    # the fault kernels at the nemesis phase's round 5: its crash window
    # down, loss and dup active, the server ledger off
    plan = nemesis_spec(faults, N_NODES, dup=True).compile(device)
    up = faults.node_up(plan, 5, torch.arange(N_NODES, device=device))
    coins = broadcast._coins(plan, 5, True, out_ok=False)
    flags = kernels.fault_coins(nbrs, up, **coins)
    n_send, n_del, n_dup = (int(((flags & bit) != 0).sum()) for bit in (
        kernels.FLAG_SEND, kernels.FLAG_DEL, kernels.FLAG_DUP))
    for w, n in GATHER_SHAPES:
        payload, recv, _, _ = gather_inputs(w, n, 2, device, topology)
        edges, words = n * DEGREE, n * w
        runs = {
            "gather_or": (
                lambda: kernels.gather_or(payload, nbrs),
                lambda: kernels.gather_or_plain(payload, nbrs),
                bound(4 * words + 4 * edges + 4 * words, 2 * edges * w)),
            "gather_flood_round": (
                lambda: kernels.gather_flood_round(payload, recv, nbrs),
                lambda: kernels.gather_flood_round_plain(payload, recv, nbrs),
                bound(2 * 4 * words + 4 * edges + 2 * 4 * words,
                      (2 * edges + 3 * n) * w)),
            "sync_diff_pc": (
                lambda: kernels.sync_diff_pc(payload, recv, nbrs),
                lambda: kernels.sync_diff_pc_plain(payload, recv, nbrs),
                bound(2 * 4 * words + 4 * edges + 4, 4 * edges * w)),
            "col_popcount_nm": (
                lambda: kernels.col_popcount(payload, node_major=True),
                lambda: kernels.col_popcount_plain(payload, node_major=True),
                bound(4 * words + 4 * n, 2 * words)),
            # the table, up and the flag bytes; a hash of some 13 integer
            # operations a drawn coin (loss on every sent edge, dup on
            # every delivered one) and a few an edge besides.  Its W is
            # the state's, not its own: the same work at both shapes
            "fault_coins": (
                lambda: kernels.fault_coins(nbrs, up, **coins),
                lambda: kernels.fault_coins_plain(nbrs, up, **coins),
                bound(4 * edges + n + edges,
                      13 * (n_send + n_del) + 8 * edges)),
            # payload and rec0 (also the dup rows), the table, the flags,
            # new and rec_next: an OR a delivered or duplicated word, a
            # popcount a duplicated one, and the merge
            "faulted_gather_round": (
                lambda: kernels.faulted_gather_round(payload, recv, recv,
                                                     nbrs, flags),
                lambda: kernels.faulted_gather_round_plain(
                    payload, recv, recv, nbrs, flags),
                bound(2 * 4 * words + 5 * edges + 2 * 4 * words + 8,
                      (2 * (n_del + n_dup) + n_dup) * w + 3 * n * w)),
        }
        for name, (kern, plain, b) in runs.items():
            out[name][(w, n)] = _timed(name, kern, plain, b)
        del payload, recv
        torch.cuda.empty_cache()
    del nbrs, flags, plan, up
    # the masked exchanges and the words-major coins on the rows of the
    # structured fault phases at round 5: the tree nemesis's two delivery
    # rows, the circulant's eight under config4c's window; the exchanges
    # at both main shapes, the coins (their own (D, N) rows) once
    n, k = N_NODES, BRANCHING
    spec = tree_nemesis_spec(faults, n)
    plan = spec.compile(device)
    arrs = structured.make_nemesis("tree", n, spec, device=device).arrs
    live = faults.wm_live_rows(plan, 5, arrs, (), ())
    rows, _ = faults.wm_live_del(plan, 5, arrs, (), (), True)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    dirs = structured.shift_dirs("circulant", n, strides=strides)
    exists, same = structured.fault_masks(
        "circulant", n, config4c_parts(broadcast, n)[1], strides=strides)
    circ = kernels.pack_bits(torch.from_numpy(exists & same[0])).to(device)
    coins = dict(t=5, seed=plan.seed, loss_num=plan.loss_num,
                 dup_num=plan.dup_num, loss=True, dup=True, srv=False)
    nw, d_circ, d_tree = kernels.packed_words(n), len(dirs.offs), 2
    for w, _ in MAIN_SHAPES:
        fr = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                           device=device, generator=gen)
        words = w * n
        runs = {
            # the payload, the inbox and the two packed rows; a bit, a
            # load, an AND and an OR for the parent and each child
            "tree_masked_exchange": (
                lambda: kernels.tree_masked_exchange(fr, rows[0], rows[1],
                                                     k),
                lambda: kernels.tree_masked_exchange_plain(fr, rows[0],
                                                           rows[1], k),
                bound(2 * 4 * words + 2 * 4 * nw, 3 * (k + 1) * words)),
            "shift_masked_exchange": (
                lambda: kernels.shift_masked_exchange(fr, circ, dirs),
                lambda: kernels.shift_masked_exchange_plain(fr, circ, dirs),
                bound(2 * 4 * words + 4 * d_circ * nw, 3 * d_circ * words)),
        }
        for name, (kern, plain, b) in runs.items():
            out[name][(w, n)] = _timed(name, kern, plain, b)
        # the masked shift kernel's tile, the design's alternative: smaller
        # tiles give an SM more blocks (its device ms by tile cap)
        out["shift_masked_exchange"][(w, n)]["device_ms_by_tile"] = {
            tile: device_ms(
                lambda: kernels.shift_masked_exchange(fr, circ, dirs, tile),
                KERNELS["shift_masked_exchange"][2], calls=10)
            for tile in MASKED_TILES}
        del fr
        torch.cuda.empty_cache()
    # the words-major coins, keyed (D, N): the tree nemesis's two delivery
    # rows at round 5 (loss and dup), and the eight degree rows in ledger
    # mode of the loss-only plan under config4c's window at round 5 (the
    # accounted circulant phase's); the packed rows in, one or two out,
    # and the integer operations the coins drawn need (coin_ops)
    loss_spec = loss_only_spec(faults, n)
    loss_plan = loss_spec.compile(device)
    parts, group = config4c_parts(broadcast, n)
    carrs = structured.make_nemesis("circulant", n, loss_spec, groups=group,
                                    device=device, strides=strides).arrs
    clive = faults.wm_live_rows(loss_plan, 5, carrs, parts.starts,
                                parts.ends, deg=True)
    cases = {(d_tree, n): (arrs.coin_dirs, arrs.src, arrs.dst, live, coins),
             (len(strides) * 2, n): (
                 carrs.deg_coin_dirs, carrs.deg_src, carrs.deg_dst, clive,
                 dict(t=5, seed=loss_plan.seed, loss_num=loss_plan.loss_num,
                      dup_num=loss_plan.dup_num, loss=True, dup=False,
                      srv=True))}
    for key, (cdirs, src, dst, lv, kw) in cases.items():
        d = cdirs.shape[0]
        # the coins this input draws: delivery, a loss coin a live edge
        # and a dup coin a delivered one; ledger, a reply coin a live
        # edge and a forward coin an edge whose reply was kept (out0)
        n_live = int(kernels.popcount(lv).sum())
        kept = int(kernels.popcount(
            kernels.wm_fault_coins(cdirs, n, lv, **kw)[0]).sum())
        n_loss = (n_live + kept if kw["srv"] else n_live) if kw["loss"] \
            else 0
        n_dup = kept if kw["dup"] and not kw["srv"] else 0
        moved = 4 * d * nw * (2 if kw["srv"] or kw["dup"] else 1) + 4 * d * nw
        ops = coin_ops(cdirs, n, n_loss, n_dup)
        out["wm_fault_coins"][key] = _timed(
            "wm_fault_coins",
            lambda: kernels.wm_fault_coins(cdirs, n, lv, **kw),
            lambda: kernels.wm_fault_coins_plain(src, dst, lv, **kw),
            bound(moved, ops))
        out["wm_fault_coins"][key].update({
            "ops": ops, "live_edges": n_live, "loss_coins": n_loss,
            "dup_coins": n_dup})
    time_ring_kernels(kernels, structured, out, gen, strides, device)
    time_counter(kernels, device, out)
    return out


def delay_rows(d: int, n: int):
    """run_all.py config4d's law: ``default_rng(11).choice([1, 3], (d,
    n), p=[0.7, 0.3])``, and the generator, which draws the per-direction
    delays next."""
    import numpy as np

    rng = np.random.default_rng(11)
    return rng.choice([1, 3], (d, n), p=[0.7, 0.3]).astype(np.int32), rng


def ring_table(ed, t: int, class_rows):
    """The ring kernel's operands that an edge-delayed bundle ``ed``
    builds at round ``t``: (table, packed rows) — the tree's (slot, kind,
    row) entries or a shift ring table — and, per delay class, the
    (slot, rows) of the masked exchange that the composition launches."""
    import torch

    ring = ed.ring
    terms = [(d, (t - (v - 1)) % ring, j)
             for j, (d, v) in enumerate(ed.classes) if t - (v - 1) >= 0]
    per_class = {v: ((t - (v - 1)) % ring, [j for j, (_, u) in
                                            enumerate(ed.classes) if u == v])
                 for v in ed.delay_set if t - (v - 1) >= 0}
    live = class_rows[[j for _, _, j in terms]]
    return terms, live, per_class


def time_ring_kernels(kernels, structured, out, gen, strides, device):
    """The ring kernels on the delay phases' edge-delayed tables at round
    5 (classes {1, 3} both in flight, from slots 2 and 0 of a 3-slot
    ring): the tree's 2 |V| = 4 terms (w1_tree_edge_delayed) and the
    circulant's 8 directions x 2 classes = 16 rows
    (w1_circulant_delayed), at both main shapes; beside the composition
    they replace (per class one masked exchange of its slot, ORed) and
    its device time (its masked launches).  Bounds: each slot read once,
    each packed row once, the inbox written once; an AND and an OR a term
    and word (the tree's kids term k of each)."""
    import torch

    n, t, k = N_NODES, 5, BRANCHING
    nw = kernels.packed_words(n)
    rows_t, _ = delay_rows(2, n)
    rows_c, _ = delay_rows(2 * len(strides), n)
    tree_ed = structured.make_edge_delayed("tree", n, rows_t)
    circ_ed = structured.make_edge_delayed("circulant", n, rows_c,
                                           strides=strides)
    dirs = structured.shift_dirs("circulant", n, strides=strides)
    for w, _ in MAIN_SHAPES:
        ring = torch.randint(-(1 << 31), 1 << 31, (3, w, n),
                             dtype=torch.int32, device=device, generator=gen)
        words = w * n
        cases = {}
        # the tree: (slot, kind, row) entries over the class rows
        cr = tree_ed.class_rows(device)
        terms, live, per_class = ring_table(tree_ed, t, cr)
        table = [(slot, kernels.TREE_PARENT if d == 0 else kernels.TREE_KIDS,
                  j) for j, (d, slot, _) in enumerate(terms)]
        zero = torch.zeros(nw, dtype=torch.int32, device=device)

        def tree_comp(ring=ring, cr=cr, per_class=per_class):
            acc = None
            for slot, js in per_class.values():
                rows = {tree_ed.classes[j][0]: cr[j] for j in js}
                term = kernels.tree_masked_exchange(
                    ring[slot], rows.get(0, zero), rows.get(1, zero), k)
                acc = term if acc is None else acc | term
            return acc

        ops = sum(k if kind == kernels.TREE_KIDS else 1
                  for _, kind, _ in table) * 2 * words
        cases["tree_ring_exchange"] = (
            lambda: kernels.tree_ring_exchange(ring, table, live, k),
            lambda: kernels.tree_ring_exchange_plain(ring, table, live, k),
            bound(4 * 2 * words + 4 * nw * len(table) + 4 * words, ops),
            tree_comp, "tree_masked_exchange", len(per_class), len(table))
        # the circulant: a 16-row ring table
        cr_c = circ_ed.class_rows(device)
        terms_c, live_c, per_c = ring_table(circ_ed, t, cr_c)
        rtable = kernels.ShiftDirs(
            tuple(dirs.offs[d] for d, _, _ in terms_c),
            tuple(dirs.flags[d] for d, _, _ in terms_c), dirs.cols,
            tuple(slot for _, slot, _ in terms_c))
        # the composition's per-class rows: every direction, its bit where
        # the class holds the edge
        comp_rows = {}
        for v, (slot, js) in per_c.items():
            rows = torch.zeros((len(dirs.offs), nw), dtype=torch.int32,
                               device=device)
            for j in js:
                rows[circ_ed.classes[j][0]] = cr_c[j]
            comp_rows[v] = (slot, rows)

        def circ_comp(ring=ring, comp_rows=comp_rows):
            acc = None
            for slot, rows in comp_rows.values():
                term = kernels.shift_masked_exchange(ring[slot], rows, dirs)
                acc = term if acc is None else acc | term
            return acc

        cases["shift_ring_exchange"] = (
            lambda: kernels.shift_ring_exchange(ring, rtable, live_c),
            lambda: kernels.shift_ring_exchange_plain(ring, rtable, live_c),
            bound(4 * 2 * words + 4 * nw * len(terms_c) + 4 * words,
                  2 * len(terms_c) * words),
            circ_comp, "shift_masked_exchange", len(comp_rows),
            len(terms_c))
        for name, (kern, plain, b, comp, masked, launches,
                   rows) in cases.items():
            if not torch.equal(kern(), comp()):
                raise AssertionError(f"{name} differs from the composition "
                                     "of masked exchanges it replaces")
            rec = _timed(name, kern, plain, b)
            masked_ms = device_ms(comp, KERNELS[masked][2], calls=10)
            rec.update({
                "table_rows": rows, "slots_read": 2,
                "composition_ms": cuda_ms(comp),
                "composition_launches": launches,
                "composition_device_ms": None if masked_ms is None
                else launches * masked_ms})
            out[name][(w, n)] = rec
        # the shift ring plan on a line of its own: its tile, stages and
        # windows; each payload word crosses from L2 to the SMs once a
        # window (the floor above the bytes bound at the L2 probe's rate)
        plan = list(kernels._shift_plan(rtable, n, False, kernels.SHIFT_TILE,
                                        True)[0])
        emit({"phase": "ring_plan", "kernel": "shift_ring_exchange",
              "at": [w, n], "table_rows": len(terms_c), "tile": plan[0],
              "stages": plan[1], "stage_bytes": 4 * plan[2],
              "windows": plan[5],
              "l2_floor_ms": plan[5] * 4 * words / L2_BYTES_PER_S * 1e3})
        del ring
        torch.cuda.empty_cache()


def same_state(a, b) -> bool:
    return (a.t == b.t and int(a.msgs) == int(b.msgs)
            and bool((a.received.cpu() == b.received.cpu()).all())
            and (a.srv_msgs is None) == (b.srv_msgs is None)
            and (a.srv_msgs is None or int(a.srv_msgs) == int(b.srv_msgs)))


def fixed_run(timing, broadcast, topology: str, n: int, n_values: int,
              device: str, **kw):
    sim = timing.structured_sim(topology, n, n_values, device=device, **kw)
    rounds = timing.discover_rounds(topology, n, n_values, **kw)
    state0, target = sim.stage(broadcast.make_inject(n, n_values))
    final = sim.run_staged_fixed(state0, rounds)
    if not sim.converged(final, target):
        raise AssertionError(f"{device} {topology} fixed run at n={n} did "
                             "not converge")
    return final


class Launches:
    """Per-phase kernel launch counts, summed over the main-path phases
    and kept per phase."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.total = {name: 0 for name in kernels.LAUNCHES}
        self.by_phase: dict[str, dict] = {}

    def start(self) -> None:
        import torch

        self.kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()

    def split(self, name: str) -> dict:
        """One kernel's launches by path: the 1M-node floods at W = 128
        and at W = 1 (gather phases included), and the small floods."""
        out = {"n1m_w128": 0, "n1m_w1": 0, "small_floods": 0}
        for phase, counts in self.by_phase.items():
            key = ("small_floods" if phase == "small_floods" else
                   "n1m_w128" if phase.startswith("w128_") else "n1m_w1")
            out[key] += counts[name]
        return out

    def stop(self, rec: dict, expect: tuple) -> None:
        import torch

        torch.cuda.synchronize()
        counts = dict(self.kernels.LAUNCHES)
        rec["launches"] = {k: v for k, v in counts.items() if v}
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        for name, count in counts.items():
            self.total[name] += count
        self.by_phase[rec["phase"]] = counts
        missing = [name for name in expect if counts[name] == 0]
        if missing:
            raise AssertionError(f"{rec['phase']}: kernels {missing} were "
                                 "never launched")


def timed_phase(name: str, topo: str, n_values: int, kw: dict, n_dirs: int,
                timing, broadcast, device) -> tuple[dict, object]:
    """The timed fixed-trip flood of one main-path entry; returns its
    JSON record and final state."""
    import torch

    res = timing.bench_structured(
        N_NODES, [(name, topo, n_values, kw, n_dirs)], device=device)[name]
    state = res["_state"]
    if state.t != res["rounds"]:
        raise AssertionError(f"{name}: t = {state.t}")
    if int(state.msgs) != res["msgs64"] % (1 << 32):
        raise AssertionError(f"{name}: msgs {int(state.msgs)} is not the "
                             f"closed form {res['msgs64']} mod 2^32")
    # one more run of the loop under the profiler: the device's busy time
    # against the timed wall gives its idle share
    sim = timing.structured_sim(topo, N_NODES, n_values, device=device,
                                **kw)
    loop_fn, _ = sim.build_fixed(res["rounds"], donate=True)
    inject = broadcast.make_inject(N_NODES, n_values)

    def staged():
        state0, _ = sim.stage(inject)
        return lambda: loop_fn(state0.received, state0.frontier)

    busy_ms = device_busy_ms(staged)
    del sim
    torch.cuda.synchronize()
    record = {"phase": name, "n": N_NODES, "n_values": n_values,
              "rounds": res["rounds"], "wall_ms": res["wall_s"] * 1e3,
              "samples_ms": [s * 1e3 for s in res["samples_s"]],
              "ms_per_round": res["ms_per_round"],
              "gbytes_per_s_lb": res["gbytes_per_s_lb"],
              "device_busy_ms": busy_ms,
              "device_idle_share": idle_share(busy_ms, res["wall_s"] * 1e3),
              "msgs": int(state.msgs), "msgs64": res["msgs64"]}
    return record, state


def w1_structured(name: str, topo: str, kw: dict, n_dirs: int, expect,
                  modules, device, launches: Launches,
                  want_rounds: int | None = None, gather_nbrs=None) -> None:
    """A W = 1 structured phase: the timed flood, the accounted run with
    the server ledger on, the CPU path at the same size, and (given
    ``gather_nbrs``) the node-major gather path on the same graph."""
    import torch

    broadcast, timing = modules
    launches.start()
    rec, state = timed_phase(name, topo, W1_VALUES, kw, n_dirs, timing,
                             broadcast, device)
    if want_rounds is not None and rec["rounds"] != want_rounds:
        raise AssertionError(f"{name}: {rec['rounds']} rounds, expected "
                             f"{want_rounds}")
    acct = timing.structured_sim(topo, N_NODES, W1_VALUES, srv_ledger=True,
                                 device=device, **kw)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)
    state_a, rounds_a = acct.run_fused(inject)
    if rounds_a != rec["rounds"] or int(state_a.msgs) != rec["msgs"]:
        raise AssertionError(f"{name} accounted run: {rounds_a} rounds, "
                             f"msgs {int(state_a.msgs)}; fixed run: "
                             f"{rec['rounds']}, {rec['msgs']}")
    if gather_nbrs is not None:
        gsim = broadcast.BroadcastSim(gather_nbrs, n_values=W1_VALUES,
                                      sync_every=acct.sync_every,
                                      device=device)
        state_g, rounds_g = gsim.run_fused(inject)
        if not (rounds_g == rounds_a and int(state_g.msgs) == rec["msgs"]
                and int(state_g.srv_msgs) == int(state_a.srv_msgs)
                and (gsim.received_node_major(state_g)
                     == acct.received_node_major(state_a)).all()):
            raise AssertionError(f"{name}: the gather path on the same "
                                 "graph differs from the structured path")
        rec["gather_rounds"] = rounds_g
        del state_g, gsim
    launches.stop(rec, expect)
    # the port's plain CPU path at the same size, bit for bit
    cpu_fixed = fixed_run(timing, broadcast, topo, N_NODES, W1_VALUES,
                          "cpu", **kw)
    cpu_acct = timing.structured_sim(topo, N_NODES, W1_VALUES,
                                     srv_ledger=True, device="cpu", **kw)
    cpu_state_a, cpu_rounds_a = cpu_acct.run_fused(inject)
    if not (same_state(state, cpu_fixed) and cpu_rounds_a == rounds_a
            and same_state(state_a, cpu_state_a)):
        raise AssertionError(f"{name}: GPU run differs from the CPU path")
    rec.update({"srv_msgs": acct.server_msgs(state_a),
                "accounted_rounds": rounds_a, "cpu_match": True})
    emit(rec)
    del state, state_a, acct, cpu_fixed, cpu_state_a
    torch.cuda.empty_cache()


def w128_structured(name: str, topo: str, kw_for, n_dirs: int, expect,
                    modules, device, launches: Launches,
                    want_rounds: int | None = None) -> None:
    """A W = 128 structured phase: the timed flood and its unwrapped
    ledger, then the GPU path against the CPU path at CHECK_NODES."""
    import torch

    broadcast, timing = modules
    launches.start()
    rec, state = timed_phase(name, topo, W128_VALUES, kw_for(N_NODES),
                             n_dirs, timing, broadcast, device)
    if want_rounds is not None and rec["rounds"] != want_rounds:
        raise AssertionError(f"{name}: {rec['rounds']} rounds, expected "
                             f"{want_rounds}")
    launches.stop(rec, expect)
    del state
    torch.cuda.empty_cache()
    kw = kw_for(CHECK_NODES)
    gpu_small = fixed_run(timing, broadcast, topo, CHECK_NODES, W128_VALUES,
                          device, **kw)
    cpu_small = fixed_run(timing, broadcast, topo, CHECK_NODES, W128_VALUES,
                          "cpu", **kw)
    if not same_state(gpu_small, cpu_small):
        raise AssertionError(f"{name}: GPU run differs from the CPU path "
                             f"at n={CHECK_NODES}")
    rec.update({"cpu_check_n": CHECK_NODES, "cpu_match": True})
    emit(rec)


GATHER_EXPECT = ("gather_flood_round", "col_popcount_nm", "sync_diff_pc")


def gather_phases(modules, topology, device, launches: Launches) -> None:
    """Config 4b, the uniform random-regular epidemic through the
    node-major gather: fault-free (timed, then accounted) and under one
    half/half partition window."""
    import numpy as np
    import torch

    broadcast, timing = modules
    nbrs = topology.random_regular(N_NODES, DEGREE, seed=0)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)

    def sim(device, **kw):
        return broadcast.BroadcastSim(nbrs, n_values=W1_VALUES,
                                      device=device, **kw)

    launches.start()
    fast = sim(device, sync_every=1 << 20, srv_ledger=False)
    _, rounds = fast.run(inject)                # host-stepped discovery
    tr = timing.TimedRun(fast, inject, rounds)
    tr.prepare()
    tr.sample(3)
    wall_s, _, state = tr.finish()

    def staged():
        state0, _ = fast.stage(inject)
        return lambda: fast.run_staged_fixed(state0, rounds, donate=True)

    busy_ms = device_busy_ms(staged)
    rec = {"phase": "w1_random_regular", "n": N_NODES, "degree": DEGREE,
           "n_values": W1_VALUES, "rounds": rounds, "wall_ms": wall_s * 1e3,
           "samples_ms": [s * 1e3 for s in tr.samples],
           "ms_per_round": wall_s / rounds * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": idle_share(busy_ms, wall_s * 1e3),
           "msgs": int(state.msgs)}
    acct = sim(device, sync_every=4)
    state_a, rounds_a = acct.run_fused(inject)
    launches.stop(rec, GATHER_EXPECT)
    cpu_a, cpu_rounds_a = sim("cpu", sync_every=4).run_fused(inject)
    if not (cpu_rounds_a == rounds_a and same_state(state_a, cpu_a)):
        raise AssertionError("w1_random_regular: GPU accounted run differs "
                             "from the CPU path")
    rec.update({"accounted_sync_every": 4, "accounted_rounds": rounds_a,
                "accounted_msgs": int(state_a.msgs),
                "srv_msgs": acct.server_msgs(state_a), "cpu_match": True})
    emit(rec)
    del fast, tr, state, acct, state_a, cpu_a
    torch.cuda.empty_cache()

    group = np.random.default_rng(7).integers(0, 2, N_NODES).astype(
        np.int8)[None, :]
    parts = broadcast.Partitions.from_numpy([2], [24], group)
    launches.start()
    part = sim(device, sync_every=16, parts=parts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_p, rounds_p = part.run_fused(inject)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not part.converged(state_p, part.target_bits(inject)) \
            or rounds_p <= 24:
        raise AssertionError(f"w1_random_regular_partitioned: {rounds_p} "
                             "rounds, not converged after the window")
    rec = {"phase": "w1_random_regular_partitioned", "n": N_NODES,
           "n_values": W1_VALUES, "window": [2, 24], "sync_every": 16,
           "rounds": rounds_p, "run_ms_host_clock": run_s * 1e3,
           "msgs": int(state_p.msgs), "srv_msgs": part.server_msgs(state_p)}
    launches.stop(rec, GATHER_EXPECT)
    cpu_p, cpu_rounds_p = sim("cpu", sync_every=16,
                              parts=parts).run_fused(inject)
    if not (cpu_rounds_p == rounds_p and same_state(state_p, cpu_p)):
        raise AssertionError("w1_random_regular_partitioned: GPU run "
                             "differs from the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del part, state_p, cpu_p
    torch.cuda.empty_cache()


NEMESIS_EXPECT = ("fault_coins", "faulted_gather_round", "col_popcount_nm")


def nemesis_phases(modules, faults, topology, device,
                   launches: Launches) -> None:
    """Config 4b's graph under the Maelstrom nemesis through the faulted
    gather round: crash + loss + dup with the server ledger off (run to
    convergence host-stepped, then the fixed trip timed), and crash +
    loss under config 4c's partition window with the ledger on; each
    held against the CPU path bit for bit."""
    import numpy as np
    import torch

    broadcast, timing = modules
    nbrs = topology.random_regular(N_NODES, DEGREE, seed=0)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)

    def sim(spec, device, **kw):
        return broadcast.BroadcastSim(
            nbrs, n_values=W1_VALUES, fault_plan=spec.compile(device),
            device=device, **kw)

    spec = nemesis_spec(faults, N_NODES, dup=True)
    launches.start()
    nem = sim(spec, device, sync_every=4, srv_ledger=False)
    state, rounds = nem.run(inject)             # host-stepped discovery
    # the crashed rows restart empty at round 12: no run converges before
    # the last faulted round has run
    if not nem.converged(state, nem.target_bits(inject)) \
            or rounds < spec.clear_round:
        raise AssertionError(f"w1_random_regular_nemesis: {rounds} rounds, "
                             "not converged once the faults cleared at "
                             f"round {spec.clear_round}")
    tr = timing.TimedRun(nem, inject, rounds)
    tr.prepare()
    tr.sample(3)
    wall_s, _, fixed = tr.finish()

    def staged():
        state0, _ = nem.stage(inject)
        return lambda: nem.run_staged_fixed(state0, rounds, donate=True)

    busy_ms = device_busy_ms(staged)
    rec = {"phase": "w1_random_regular_nemesis", "n": N_NODES,
           "degree": DEGREE, "n_values": W1_VALUES, "sync_every": 4,
           "crash": [2, 12, "range(0, n, 97)"], "loss_rate": 0.1,
           "dup_rate": 0.05, "until": 13, "clear_round": spec.clear_round,
           "rounds": rounds, "wall_ms": wall_s * 1e3,
           "samples_ms": [s * 1e3 for s in tr.samples],
           "ms_per_round": wall_s / rounds * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": idle_share(busy_ms, wall_s * 1e3),
           "msgs": int(state.msgs)}
    launches.stop(rec, NEMESIS_EXPECT)
    cpu, cpu_rounds = sim(spec, "cpu", sync_every=4,
                          srv_ledger=False).run(inject)
    if not (cpu_rounds == rounds and same_state(state, cpu)
            and same_state(fixed, cpu)):
        raise AssertionError("w1_random_regular_nemesis: GPU run differs "
                             "from the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del nem, tr, state, fixed, cpu
    torch.cuda.empty_cache()

    spec = nemesis_spec(faults, N_NODES, dup=False)
    group = np.random.default_rng(7).integers(0, 2, N_NODES).astype(
        np.int8)[None, :]
    parts = broadcast.Partitions.from_numpy([2], [24], group)
    launches.start()
    acct = sim(spec, device, sync_every=16, parts=parts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rounds = acct.run_fused(inject)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not acct.converged(state, acct.target_bits(inject)) \
            or rounds <= max(24, spec.clear_round):
        raise AssertionError(f"w1_random_regular_nemesis_accounted: {rounds}"
                             " rounds, not converged after the faults")
    rec = {"phase": "w1_random_regular_nemesis_accounted", "n": N_NODES,
           "n_values": W1_VALUES, "sync_every": 16, "window": [2, 24],
           "crash": [2, 12, "range(0, n, 97)"], "loss_rate": 0.1,
           "until": 13, "rounds": rounds, "run_ms_host_clock": run_s * 1e3,
           "msgs": int(state.msgs), "srv_msgs": acct.server_msgs(state)}
    launches.stop(rec, NEMESIS_EXPECT + ("sync_diff_pc",))
    cpu, cpu_rounds = sim(spec, "cpu", sync_every=16,
                          parts=parts).run_fused(inject)
    if not (cpu_rounds == rounds and same_state(state, cpu)):
        raise AssertionError("w1_random_regular_nemesis_accounted: GPU run "
                             "differs from the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del acct, state, cpu
    torch.cuda.empty_cache()


def launches_of(kernels, run) -> int:
    """Port-kernel launches of one call of ``run``."""
    import torch

    before = sum(kernels.LAUNCHES.values())
    run()
    torch.cuda.synchronize()
    return sum(kernels.LAUNCHES.values()) - before


def timed_fixed(sim, timing, kernels, inject, rounds: int) -> dict:
    """The fixed trip of ``rounds`` rounds timed with CUDA events (median
    of 3), its device busy time and spans under the profiler, and the
    port-kernel launches of one run; checks that it converges."""
    tr = timing.TimedRun(sim, inject, rounds)
    tr.prepare()
    tr.sample(3)
    wall_s, _, fixed = tr.finish()

    def staged():
        state0, _ = sim.stage(inject)
        return lambda: sim.run_staged_fixed(state0, rounds, donate=True)

    busy_ms, spans = busy_and_spans(staged)
    port = launches_of(kernels, staged())
    return {"wall_ms": wall_s * 1e3,
            "samples_ms": [x * 1e3 for x in tr.samples],
            "ms_per_round": wall_s / rounds * 1e3,
            "device_busy_ms": busy_ms,
            "device_idle_share": idle_share(busy_ms, wall_s * 1e3),
            "port_launches_per_round": port / rounds,
            "device_spans_per_round": None if spans is None
            else spans / rounds}, fixed


def same_run(a_sim, a, b_sim, b) -> bool:
    """Two runs on (possibly) different layouts and devices agree: t,
    ledgers and the received sets."""
    return (a.t == b.t and int(a.msgs) == int(b.msgs)
            and (a.srv_msgs is None) == (b.srv_msgs is None)
            and (a.srv_msgs is None or int(a.srv_msgs) == int(b.srv_msgs))
            and bool((a_sim.received_node_major(a)
                      == b_sim.received_node_major(b)).all()))


def structured_fault_phases(modules, faults, structured, kernels, topology,
                            device, launches: Launches) -> None:
    """Maelstrom's faults on the structured main path at 2^20 nodes:
    config4c's partition window on the circulant, fault_sweep.py's
    structured plan on the tree, and a loss-only plan under config4c's
    window with the server ledger on; each held against the port's CPU
    path and the card's gather path on the same graph."""
    import torch

    broadcast, timing = modules
    n = N_NODES
    inject = broadcast.make_inject(n, W1_VALUES)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    circ_nbrs = topology.circulant(n, strides)
    parts, group = config4c_parts(broadcast, n)

    # -- w1_circulant_partitioned: config4c ---------------------------
    def part_sim(dev, srv):
        return timing.structured_sim("circulant", n, W1_VALUES,
                                     sync_every=16, parts=parts,
                                     srv_ledger=srv, device=dev,
                                     strides=strides)

    launches.start()
    fast = part_sim(device, False)
    state, rounds = fast.run_fused(inject)
    if not fast.converged(state, fast.target_bits(inject)) or rounds <= 24:
        raise AssertionError(f"w1_circulant_partitioned: {rounds} rounds, "
                             "not converged after the window")
    rec = {"phase": "w1_circulant_partitioned", "n": n,
           "n_values": W1_VALUES, "window": [2, 24], "sync_every": 16,
           "rounds": rounds}
    timed, fixed = timed_fixed(fast, timing, kernels, inject, rounds)
    rec.update(timed)
    acct = part_sim(device, True)
    state_a, rounds_a = acct.run_fused(inject)
    gsim = broadcast.BroadcastSim(circ_nbrs, n_values=W1_VALUES,
                                  sync_every=16, parts=parts, device=device)
    state_g, rounds_g = gsim.run_fused(inject)
    launches.stop(rec, ("shift_masked_exchange", "shift_exchange",
                        "col_popcount", "gather_flood_round"))
    if not (rounds_a == rounds_g == rounds and same_run(fast, state, fast,
                                                        fixed)
            and int(state_a.msgs) == int(state.msgs)
            and same_run(acct, state_a, gsim, state_g)):
        raise AssertionError("w1_circulant_partitioned: the fixed, "
                             "accounted and gather runs differ")
    cpu = part_sim("cpu", True)
    cpu_state, cpu_rounds = cpu.run_fused(inject)
    if not (cpu_rounds == rounds and same_run(acct, state_a, cpu,
                                              cpu_state)):
        raise AssertionError("w1_circulant_partitioned: GPU run differs "
                             "from the CPU path")
    rec.update({"msgs": int(state_a.msgs),
                "srv_msgs": acct.server_msgs(state_a),
                "gather_rounds": rounds_g, "cpu_match": True})
    emit(rec)
    del fast, state, fixed, acct, state_a, gsim, state_g, cpu, cpu_state
    torch.cuda.empty_cache()

    # -- w1_tree_nemesis: fault_sweep.py --structured ----------------
    spec = tree_nemesis_spec(faults, n)
    tree_nbrs = topology.to_padded_neighbors(topology.tree(n, BRANCHING))

    def tree_sim(dev, structured_path):
        kw = (dict(exchange=structured.make_exchange("tree", n),
                   nemesis=structured.make_nemesis("tree", n, spec,
                                                   device=dev))
              if structured_path else {})
        return broadcast.BroadcastSim(tree_nbrs, n_values=W1_VALUES,
                                      sync_every=8, srv_ledger=False,
                                      fault_plan=spec.compile(dev),
                                      device=dev, **kw)

    launches.start()
    nem = tree_sim(device, True)
    state, rounds = nem.run(inject)            # host-stepped discovery
    if not nem.converged(state, nem.target_bits(inject)) \
            or rounds < spec.clear_round:
        raise AssertionError(f"w1_tree_nemesis: {rounds} rounds, not "
                             "converged once the faults cleared at round "
                             f"{spec.clear_round}")
    rec = {"phase": "w1_tree_nemesis", "n": n, "n_values": W1_VALUES,
           "sync_every": 8, "crash": [2, 16, "range(0, n, 97)"],
           "loss_rate": 0.1, "dup_rate": 0.05, "until": 17,
           "clear_round": spec.clear_round, "rounds": rounds}
    timed, fixed = timed_fixed(nem, timing, kernels, inject, rounds)
    rec.update(timed)
    gsim = tree_sim(device, False)
    state_g, rounds_g = gsim.run(inject)
    launches.stop(rec, ("tree_masked_exchange", "wm_fault_coins",
                        "col_popcount", "fault_coins",
                        "faulted_gather_round"))
    if not (rounds_g == rounds and same_run(nem, state, nem, fixed)
            and same_run(nem, state, gsim, state_g)):
        raise AssertionError("w1_tree_nemesis: the structured and gather "
                             "runs differ")
    cpu = tree_sim("cpu", True)
    cpu_state, cpu_rounds = cpu.run(inject)
    if not (cpu_rounds == rounds and same_run(nem, state, cpu, cpu_state)):
        raise AssertionError("w1_tree_nemesis: GPU run differs from the "
                             "CPU path")
    rec.update({"msgs": int(state.msgs), "gather_rounds": rounds_g,
                "cpu_match": True})
    emit(rec)
    del nem, state, fixed, gsim, state_g, cpu, cpu_state
    torch.cuda.empty_cache()

    # -- w1_circulant_nemesis_accounted: loss-only under config4c -----
    spec = loss_only_spec(faults, n)

    def loss_sim(dev, structured_path):
        kw = (dict(exchange=structured.make_exchange("circulant", n,
                                                     strides=strides),
                   nemesis=structured.make_nemesis(
                       "circulant", n, spec, groups=group, device=dev,
                       strides=strides))
              if structured_path else {})
        return broadcast.BroadcastSim(circ_nbrs, n_values=W1_VALUES,
                                      sync_every=16, parts=parts,
                                      fault_plan=spec.compile(dev),
                                      device=dev, **kw)

    launches.start()
    acct = loss_sim(device, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rounds = acct.run_fused(inject)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not acct.converged(state, acct.target_bits(inject)) \
            or rounds <= max(24, spec.clear_round):
        raise AssertionError(f"w1_circulant_nemesis_accounted: {rounds} "
                             "rounds, not converged after the faults")
    rec = {"phase": "w1_circulant_nemesis_accounted", "n": n,
           "n_values": W1_VALUES, "sync_every": 16, "window": [2, 24],
           "loss_rate": 0.1, "until": 13, "rounds": rounds,
           "run_ms_host_clock": run_s * 1e3, "msgs": int(state.msgs),
           "srv_msgs": acct.server_msgs(state)}
    gsim = loss_sim(device, False)
    state_g, rounds_g = gsim.run_fused(inject)
    launches.stop(rec, ("shift_masked_exchange", "wm_fault_coins",
                        "col_popcount", "fault_coins",
                        "faulted_gather_round"))
    if not (rounds_g == rounds and same_run(acct, state, gsim, state_g)):
        raise AssertionError("w1_circulant_nemesis_accounted: the "
                             "structured and gather runs differ")
    cpu = loss_sim("cpu", True)
    cpu_state, cpu_rounds = cpu.run_fused(inject)
    if not (cpu_rounds == rounds and same_run(acct, state, cpu,
                                              cpu_state)):
        raise AssertionError("w1_circulant_nemesis_accounted: GPU run "
                             "differs from the CPU path")
    rec.update({"gather_rounds": rounds_g, "cpu_match": True})
    emit(rec)
    del acct, state, gsim, state_g, cpu, cpu_state
    torch.cuda.empty_cache()


def delayed_way(sim, timing, kernels, inject, want_rounds=None) -> tuple:
    """One way of a delay phase on the card: host-stepped discovery, then
    the fixed trip timed (:func:`timed_fixed`), which must equal it.
    Returns (record, final state)."""
    state, rounds = sim.run(inject)
    if not sim.converged(state, sim.target_bits(inject)):
        raise AssertionError(f"{rounds} rounds, not converged")
    if want_rounds is not None and rounds != want_rounds:
        raise AssertionError(f"{rounds} rounds, the gather ring took "
                             f"{want_rounds}")
    timed, fixed = timed_fixed(sim, timing, kernels, inject, rounds)
    if not same_run(sim, state, sim, fixed):
        raise AssertionError("the fixed trip differs from the host-stepped "
                             "run")
    return {"rounds": rounds, **timed, "msgs": int(state.msgs)}, state


def check_cpu(make_sim, gpu_sim, gpu_state, inject, fused=False) -> None:
    """The port's plain CPU path at the same size equals the card's run
    bit for bit (rounds, received, msgs, srv_msgs)."""
    cpu = make_sim("cpu")
    state, rounds = cpu.run_fused(inject) if fused else cpu.run(inject)
    if not (rounds == gpu_state.t
            and same_run(gpu_sim, gpu_state, cpu, state)):
        raise AssertionError("the card's run differs from the CPU path")


def delay_phases(modules, faults, structured, kernels, topology, device,
                 launches: Launches) -> None:
    """Maelstrom's per-hop latency at 2^20 nodes: run_all.py config4d (the
    circulant with per-edge delays of 1 or 3 rounds) three ways — the
    gather ring, per-direction classes and per-edge delays on the
    structured path — then under config4c's partition window; the tree
    with per-edge delays of the same law; the tree nemesis with
    dir_delays (1, 3).  Each way host-stepped, its fixed trip timed, held
    against the port's CPU path and the gather ring on the same graph."""
    import torch

    broadcast, timing = modules
    n = N_NODES
    inject = broadcast.make_inject(n, W1_VALUES)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    circ = topology.circulant(n, strides)
    ckw = {"strides": strides}
    rows, rng = delay_rows(2 * len(strides), n)
    dd = tuple(int(x) for x in
               rng.choice([1, 3], size=2 * len(strides), p=[0.7, 0.3]))
    gdelays = structured.gather_delays_from_rows("circulant", n, rows, circ,
                                                 **ckw)

    def circ_sim(way, dev, srv=False, sync_every=1 << 20, parts=None,
                 group=None):
        kw = dict(n_values=W1_VALUES, sync_every=sync_every,
                  srv_ledger=srv, parts=parts, device=dev)
        if way == "gather":
            return broadcast.BroadcastSim(circ, delays=gdelays, **kw)
        ex = structured.make_exchange("circulant", n, **ckw)
        diff = structured.make_sync_diff("circulant", n, **ckw)
        if way == "delayed":
            return broadcast.BroadcastSim(circ, exchange=ex, sync_diff=diff,
                                          delayed=structured.make_delayed(
                                              "circulant", n, dd, **ckw),
                                          **kw)
        edge = (structured.make_edge_delayed("circulant", n, rows, **ckw)
                if parts is None else structured.make_edge_delayed_faulted(
                    "circulant", n, rows, group, **ckw))
        return broadcast.BroadcastSim(circ, exchange=ex, edge_delayed=edge,
                                      sync_diff=diff if parts is None
                                      else None, **kw)

    # -- w1_circulant_delayed: run_all.py config4d -------------------
    launches.start()
    rec = {"phase": "w1_circulant_delayed", "n": n, "n_values": W1_VALUES,
           "delay_values": [1, 3], "dir_delays": list(dd), "ways": {}}
    runs = {}
    for way in ("gather", "delayed", "edge"):
        sim = circ_sim(way, device)
        want = runs["gather"][1].t if way == "edge" else None
        rec["ways"][way], state = delayed_way(sim, timing, kernels, inject,
                                              want)
        runs[way] = (sim, state)
    (gsim, gstate), (esim, estate) = runs["gather"], runs["edge"]
    if not same_run(gsim, gstate, esim, estate):
        raise AssertionError("w1_circulant_delayed: the edge-delayed "
                             "structured run differs from the gather ring")
    # accounted: the server ledger on, sync waves every 16 rounds
    acct = {}
    for way in ("gather", "edge"):
        sim = circ_sim(way, device, srv=True, sync_every=16)
        acct[way] = (sim, *sim.run_fused(inject))
    (ga, gas, gar), (ea, eas, ear) = acct["gather"], acct["edge"]
    if not (gar == ear and same_run(ga, gas, ea, eas)):
        raise AssertionError("w1_circulant_delayed: the accounted edge "
                             "run differs from the gather ring's")
    rec.update({"accounted_sync_every": 16, "accounted_rounds": ear,
                "accounted_msgs": int(eas.msgs),
                "srv_msgs": ea.server_msgs(eas)})
    launches.stop(rec, ("shift_ring_exchange", "gather_or", "col_popcount",
                        "col_popcount_nm", "sync_diff_pc"))
    for way, (sim, state) in runs.items():
        check_cpu(lambda dev, way=way: circ_sim(way, dev), sim, state,
                  inject)
    for way, (sim, state, _) in acct.items():
        check_cpu(lambda dev, way=way: circ_sim(way, dev, srv=True,
                                                  sync_every=16),
                  sim, state, inject, fused=True)
    rec["cpu_match"] = True
    emit(rec)
    del runs, acct, gsim, gstate, esim, estate, ga, gas, ea, eas
    torch.cuda.empty_cache()

    # -- w1_circulant_edge_delayed_partitioned: config4d under 4c -----
    parts, group = config4c_parts(broadcast, n)

    def part_sim(way, dev):
        return circ_sim(way, dev, srv=True, sync_every=16, parts=parts,
                        group=group)

    launches.start()
    esim = part_sim("edge", device)
    gsim = part_sim("gather", device)
    gstate, grounds = gsim.run(inject)
    timed, estate = delayed_way(esim, timing, kernels, inject, grounds)
    if not same_run(gsim, gstate, esim, estate) or grounds <= 24:
        raise AssertionError("w1_circulant_edge_delayed_partitioned: the "
                             "edge-delayed run differs from the gather "
                             "ring, or converged inside the window")
    rec = {"phase": "w1_circulant_edge_delayed_partitioned", "n": n,
           "n_values": W1_VALUES, "window": [2, 24], "sync_every": 16,
           "delay_values": [1, 3], **timed,
           "srv_msgs": esim.server_msgs(estate), "gather_rounds": grounds}
    launches.stop(rec, ("shift_ring_exchange", "gather_or", "col_popcount",
                        "sync_diff_pc"))
    check_cpu(lambda dev: part_sim("edge", dev), esim, estate, inject)
    check_cpu(lambda dev: part_sim("gather", dev), gsim, gstate, inject)
    rec["cpu_match"] = True
    emit(rec)
    del esim, gsim, gstate, estate
    torch.cuda.empty_cache()

    # -- w1_tree_edge_delayed: bench.py's tree, config4d's law --------
    tree_nbrs = topology.to_padded_neighbors(topology.tree(n, BRANCHING))
    trows, _ = delay_rows(2, n)
    tdelays = structured.gather_delays_from_rows("tree", n, trows, tree_nbrs)

    def tree_sim(way, dev):
        kw = dict(n_values=W1_VALUES, sync_every=1 << 20, srv_ledger=False,
                  device=dev)
        if way == "gather":
            return broadcast.BroadcastSim(tree_nbrs, delays=tdelays, **kw)
        return broadcast.BroadcastSim(
            tree_nbrs, exchange=structured.make_exchange("tree", n),
            edge_delayed=structured.make_edge_delayed("tree", n, trows), **kw)

    launches.start()
    gsim = tree_sim("gather", device)
    gstate, grounds = gsim.run(inject)
    esim = tree_sim("edge", device)
    timed, estate = delayed_way(esim, timing, kernels, inject, grounds)
    if not same_run(gsim, gstate, esim, estate):
        raise AssertionError("w1_tree_edge_delayed: the edge-delayed run "
                             "differs from the gather ring")
    rec = {"phase": "w1_tree_edge_delayed", "n": n, "n_values": W1_VALUES,
           "branching": BRANCHING, "delay_values": [1, 3], **timed,
           "gather_rounds": grounds}
    launches.stop(rec, ("tree_ring_exchange", "gather_or", "col_popcount",
                        "col_popcount_nm"))
    check_cpu(lambda dev: tree_sim("edge", dev), esim, estate, inject)
    rec["cpu_match"] = True
    emit(rec)
    del gsim, gstate, esim, estate
    torch.cuda.empty_cache()

    # -- w1_tree_nemesis_delayed: fault_sweep.py's plan, dir_delays ---
    spec = tree_nemesis_spec(faults, n)
    tdd = (1, 3)

    def nem_sim(structured_path, dev):
        kw = dict(n_values=W1_VALUES, sync_every=8, srv_ledger=False,
                  fault_plan=spec.compile(dev), device=dev)
        if not structured_path:
            return broadcast.BroadcastSim(
                tree_nbrs, delays=structured.gather_delays_for(
                    "tree", n, tdd, tree_nbrs), **kw)
        return broadcast.BroadcastSim(
            tree_nbrs, exchange=structured.make_exchange("tree", n),
            nemesis=structured.make_nemesis("tree", n, spec, dir_delays=tdd,
                                            device=dev), **kw)

    launches.start()
    gsim = nem_sim(False, device)
    gstate, grounds = gsim.run(inject)
    if grounds < spec.clear_round:
        raise AssertionError(f"w1_tree_nemesis_delayed: {grounds} rounds, "
                             "converged before the faults cleared")
    nsim = nem_sim(True, device)
    timed, nstate = delayed_way(nsim, timing, kernels, inject, grounds)
    if not same_run(gsim, gstate, nsim, nstate):
        raise AssertionError("w1_tree_nemesis_delayed: the structured run "
                             "differs from the gather ring")
    rec = {"phase": "w1_tree_nemesis_delayed", "n": n,
           "n_values": W1_VALUES, "sync_every": 8, "dir_delays": list(tdd),
           "crash": [2, 16, "range(0, n, 97)"], "loss_rate": 0.1,
           "dup_rate": 0.05, "until": 17, "clear_round": spec.clear_round,
           **timed, "gather_rounds": grounds}
    launches.stop(rec, ("tree_ring_exchange", "wm_fault_coins",
                        "col_popcount", "gather_or", "fault_coins"))
    check_cpu(lambda dev: nem_sim(True, dev), nsim, nstate, inject)
    rec["cpu_match"] = True
    emit(rec)
    del gsim, gstate, nsim, nstate
    torch.cuda.empty_cache()


def small_floods(modules, device, launches: Launches) -> None:
    """Grid, ring and line floods run to convergence with the server
    ledger on, on the card and on the CPU (coverage, not timing)."""
    broadcast, timing = modules
    launches.start()
    rec = {"phase": "small_floods", "runs": {}}
    for topo, n in (("grid", 1 << 16), ("ring", 4099), ("line", 4099)):
        inject = broadcast.make_inject(n, W1_VALUES)
        states = []
        for dev in (device, "cpu"):
            sim = timing.structured_sim(topo, n, W1_VALUES, srv_ledger=True,
                                        device=dev)
            states.append(sim.run_fused(inject))
        (gpu, rounds), (cpu, cpu_rounds) = states
        want = timing.discover_rounds(topo, n, W1_VALUES)
        if not (rounds == cpu_rounds == want and same_state(gpu, cpu)):
            raise AssertionError(f"small_floods {topo}: GPU run differs "
                                 "from the CPU path")
        rec["runs"][topo] = {"n": n, "rounds": rounds, "msgs": int(gpu.msgs),
                             "srv_msgs": int(gpu.srv_msgs),
                             "cpu_match": True}
    launches.stop(rec, ("shift_exchange", "col_popcount"))
    emit(rec)


# the counter phases' node counts: run_all.py config3b's and config3c's,
# fault_sweep.py's large-N counter row's, and the ids / echo phase's
COUNTER_3B_NODES = 1 << 20
COUNTER_3C_NODES = 1 << 24
COUNTER_NEMESIS_NODES = 1 << 17
IDS_ECHO_NODES = 1 << 20
# the counter kernels' checked shapes: one node, a ragged warp, a million
# and three (no multiple of 4: the scalar tail), and config3c's 2^24
COUNTER_NS = (1, 31, (1 << 20) + 3, COUNTER_3C_NODES)
# the seq-kv stale coin the checks draw: threshold 0.5, round 3, seed 5
COUNTER_STALE = {"stale_num": 1 << 31, "stale_seed": 5, "t": 3}


def counter_case(n: int, seed: int, device, gate: bool):
    """A counter round's operands from ``seed``: pending in [-3, 10) with
    one node in 64 near 2^30 (the allreduce sum wraps), cached equal to
    kv0 at half the nodes (fresh), a gate byte of every kind at a
    quarter of them, kv0 and msgs random."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=gen)

    kv0 = ints(-5, 5, ())
    pending = torch.where(ints(0, 64, (n,)) == 0, ints(1 << 29, 1 << 30,
                                                       (n,)),
                          ints(-3, 10, (n,)))
    cached = torch.where(ints(0, 2, (n,)) == 0, kv0, ints(-5, 5, (n,)))
    g = ints(0, 16, (n,))
    gates = torch.where(g < 12, 0, g & 3).to(torch.uint8) if gate else None
    msgs = ints(0, 1 << 32, (), torch.int64)
    return pending, cached, gates, kv0, msgs


def counter_modes(n: int) -> list:
    """(cas, wide) of every layout the counter takes at n nodes: cas
    packed (below 24 row bits), cas wide, allreduce."""
    row_bits = max(1, (n - 1).bit_length())
    return ([(True, False)] if row_bits < 24 else []) \
        + [(True, True), (False, False)]


def check_counter(kernels, note, device) -> None:
    """``counter_select`` and ``counter_apply`` against their plain
    versions at :data:`COUNTER_NS`: every layout, with and without the
    gate, poll and no poll, the stale coin on and off (cas), aligned and
    on 4-byte-offset views (the scalar path), out of place and in
    place."""
    import torch

    for n in COUNTER_NS:
        row_bits = max(1, (n - 1).bit_length())
        for cas, wide in counter_modes(n):
            for gate in (False, True):
                for offset in (0, 1):
                    case = counter_case(n, n + 2 * gate + offset, device,
                                        gate)
                    pending, cached, gates, kv0, msgs = case
                    poll = bool(offset) != gate
                    kw = dict(cas=cas, wide=wide, row_bits=row_bits, t=7,
                              seed=n, poll=poll)
                    views = [at_offset(x, offset) if x is not None else None
                             for x in (pending, cached, gates)]
                    wk, wp = (kernels.counter_work(device) for _ in "kp")
                    kv_k, m_k = kernels.counter_select(*views, kv0, msgs, wk,
                                                       **kw)
                    kv_p, m_p = kernels.counter_select_plain(
                        pending, cached, gates, kv0, msgs, wp, **kw)
                    note("counter_select", (kv_k, kv_p), (m_k, m_p),
                         (wk, wp))
                    for stale in ({}, COUNTER_STALE) if cas else ({},):
                        akw = dict(cas=cas, poll=poll, **stale)
                        got = kernels.counter_apply(*views, kv_k, wk, **akw)
                        want = kernels.counter_apply_plain(
                            pending, cached, gates, kv_p, wp, **akw)
                        note("counter_apply", *zip(got, want))
                        # in place, as the donated run_fused loop runs it
                        into = [at_offset(x, offset)
                                for x in (pending, cached)]
                        kernels.counter_apply(*into, views[2], kv_k, wk,
                                              out=into, **akw)
                        note("counter_apply", *zip(into, want))
                    del case, views, got, want, into
            torch.cuda.synchronize()
        torch.cuda.empty_cache()


def time_counter(kernels, device, out) -> None:
    """The counter kernels and their plain versions, keyed (1, n), at
    config3c's 2^24 (cas, the wide layout, no gate, a poll round) and
    config3b's 2^20 (allreduce under its window: half the nodes
    blocked).  Bounds: the read pass reads pending and the gate, and in
    cas mode cached (cas 8 bytes a node, allreduce gated 5), the update
    pass reads pending, cached and the gate and writes pending and
    cached (16 or 17); their integer operations a node (the read pass's
    hash, masks, key and counts: 14 in cas mode, 7 in allreduce; the
    update pass's masks and selects: 8) lie below those bytes.  Bytes
    go at HBM's rate, or at the L2's where every operand fits in the L2
    and so stays there between the timed calls (2^20: 17 MB of 50)."""
    import torch

    for n, cas, gated in ((COUNTER_3C_NODES, True, False),
                          (COUNTER_3B_NODES, False, True)):
        pending, cached, _, kv0, msgs = counter_case(n, 3, device, False)
        gate = ((torch.arange(n, device=device) < n // 2).to(torch.uint8)
                * kernels.GATE_BLOCKED if gated else None)
        kw = dict(cas=cas, wide=cas, row_bits=max(1, (n - 1).bit_length()),
                  t=4, seed=0, poll=True)
        wk, wp = kernels.counter_work(device), kernels.counter_work(device)
        kv, _ = kernels.counter_select(pending, cached, gate, kv0, msgs, wk,
                                       **kw)
        kv_p, _ = kernels.counter_select_plain(pending, cached, gate, kv0,
                                               msgs, wp, **kw)
        g_bytes = n if gated else 0
        resident = 16 * n + g_bytes <= L2_BYTES
        rate = L2_BYTES_PER_S if resident else HBM_BYTES_PER_S
        out["counter_select"][(1, n)] = _timed(
            "counter_select",
            lambda: kernels.counter_select(pending, cached, gate, kv0, msgs,
                                           wk, **kw),
            lambda: kernels.counter_select_plain(pending, cached, gate, kv0,
                                                 msgs, wp, **kw),
            bound((8 if cas else 4) * n + g_bytes, (14 if cas else 7) * n,
                  rate))
        akw = dict(cas=cas, poll=True)
        out["counter_apply"][(1, n)] = _timed(
            "counter_apply",
            lambda: kernels.counter_apply(pending, cached, gate, kv, wk,
                                          **akw),
            lambda: kernels.counter_apply_plain(pending, cached, gate, kv_p,
                                                wp, **akw),
            bound(16 * n + g_bytes, 8 * n, rate))
        for name in ("counter_select", "counter_apply"):
            out[name][(1, n)]["mode"] = "cas-wide" if cas else \
                "allreduce-gated"
            out[name][(1, n)]["bound_rate"] = "L2" if resident else "HBM"
        del pending, cached, gate, kv, kv_p
        torch.cuda.empty_cache()


COUNTER_EXPECT = ("counter_select", "counter_apply")


def counter_timed(sim, kernels, state0, rounds: int) -> dict:
    """``sim.run(state0, rounds)`` (out of place: ``state0`` stays) timed
    with CUDA events (median of 3 after a warm-up), its device busy time
    under the profiler and the port-kernel launches of one run."""
    def run():
        return sim.run(state0, rounds)

    wall = cuda_ms(run, samples=3, inner=1)
    busy, spans = busy_and_spans(lambda: run)
    port = launches_of(kernels, run)
    return {"rounds": rounds, "wall_ms": wall, "ms_per_round": wall / rounds,
            "device_busy_ms": busy,
            "device_idle_share": idle_share(busy, wall),
            "launches_per_round": port / rounds,
            "device_spans_per_round": None if spans is None
            else spans / rounds}


def same_counter(a, b) -> bool:
    """Two counter states agree: t, kv, msgs, the node rows and the KV
    rows."""
    import torch

    def eq(x, y):
        return bool(torch.equal(x.cpu(), y.cpu()))

    return (a.t == b.t and int(a.kv) == int(b.kv)
            and int(a.msgs) == int(b.msgs) and eq(a.pending, b.pending)
            and eq(a.cached, b.cached)
            and (a.rows is None) == (b.rows is None)
            and (a.rows is None or (eq(a.rows.vals, b.rows.vals)
                                    and eq(a.rows.vers, b.rows.vers))))


def counter_nemesis_spec(faults, n: int):
    """benchmarks/fault_sweep.py ``_large_n_faulted_rows``'s counter plan
    at seed 0: ``random_spec(n, seed=1, horizon=12, n_crash_windows=2,
    loss_rate=0.1)`` with its crash windows and loss horizon moved 4
    rounds later (``_shift_crash``); no dup stream."""
    spec = faults.random_spec(n, seed=1, horizon=12, n_crash_windows=2,
                              loss_rate=0.1)
    meta = spec.to_meta()
    meta["crash"] = [[s + 4, e + 4, ns] for s, e, ns in meta["crash"]]
    meta["loss_until"] += 4
    return faults.NemesisSpec.from_meta(meta)


def counter_phases(counter, faults, kernels, device, launches: Launches,
                   card: str) -> None:
    """benchmarks/run_all.py's counter configs on the card (config3b at
    2^20, config3c at 2^24) and fault_sweep.py's large-N counter plan at
    2^17 over the device KV, each held to its own ok condition and to the
    port's CPU path."""
    import numpy as np
    import torch

    # config3b: half the nodes cut off the KV for rounds [0, 8) of 16
    n, rounds = COUNTER_3B_NODES, 16
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    blocked = np.zeros((1, n), bool)
    blocked[0, : n // 2] = True

    def sim3b(dev):
        return counter.CounterSim(
            n, mode="allreduce", poll_every=2, device=dev,
            kv_sched=counter.KVReach.from_numpy([0], [8], blocked))

    launches.start()
    sim = sim3b(device)
    st0 = sim.add(sim.init_state(), deltas)
    rec = {"phase": "counter_1m_partitioned", "card": card, "n": n,
           "mode": "allreduce", "window": [0, 8], "poll_every": 2,
           **counter_timed(sim, kernels, st0, rounds)}
    st = sim.run(st0, rounds)
    total = int(deltas.sum())
    ok = sim.kv_value(st) == total and bool((sim.reads(st) == total).all())
    rec.update(kv=sim.kv_value(st), msgs=int(st.msgs), ok=ok)
    launches.stop(rec, COUNTER_EXPECT)
    cpu = sim3b("cpu")
    if not (ok and same_counter(st, cpu.run(cpu.add(cpu.init_state(),
                                                    deltas), rounds))):
        raise AssertionError(f"counter_1m_partitioned: ok {ok}, or the GPU "
                             "run differs from the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del sim, st0, st, cpu
    torch.cuda.empty_cache()

    # config3c: cas at 2^24 nodes, the wide winner layout, 16 rounds
    n = COUNTER_3C_NODES
    deltas = np.random.default_rng(0).integers(1, 10, n).astype(np.int32)

    def sim3c(dev):
        return counter.CounterSim(n, mode="cas", poll_every=4, device=dev)

    launches.start()
    sim = sim3c(device)
    if not sim._wide:
        raise AssertionError("2^24 nodes must select the wide winner layout")
    st0 = sim.add(sim.init_state(), deltas)
    rec = {"phase": "counter_16m_cas_wide", "card": card, "n": n,
           "mode": "cas", "winner_key": "wide", "poll_every": 4,
           **counter_timed(sim, kernels, st0, rounds)}
    st = sim.run(st0, rounds)
    drained = int((st0.pending - st.pending).sum(dtype=torch.int64))
    n_drained = int((st.pending == 0).sum())
    ok = sim.kv_value(st) == drained and n_drained == rounds
    fused = sim.run_fused(sim.add(sim.init_state(), deltas), rounds)
    rec.update(kv=sim.kv_value(st), drained=drained, n_drained=n_drained,
               msgs=int(st.msgs), ok=ok,
               fused_match=same_counter(st, fused))
    launches.stop(rec, COUNTER_EXPECT)
    del fused
    cpu = sim3c("cpu")
    if not (ok and rec["fused_match"]
            and same_counter(st, cpu.run(cpu.add(cpu.init_state(), deltas),
                                         rounds))):
        raise AssertionError(f"counter_16m_cas_wide: ok {ok}, or the GPU "
                             "run differs from run_fused or the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del sim, st0, st, cpu
    torch.cuda.empty_cache()

    # fault_sweep.py's counter plan at 2^17 over the device KV: allreduce
    # with the fault gate swept in slabs and kv_amnesia, run to
    # convergence; then cas with seq-kv stale reads for a fixed trip
    n = COUNTER_NEMESIS_NODES
    spec = counter_nemesis_spec(faults, n)
    clear = spec.clear_round
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    acked = int(deltas.sum())
    members = torch.from_numpy(spec.host_members(clear)).to(device)
    ways = {
        "allreduce": dict(mode="allreduce", union_block=4096,
                          kv_amnesia=True),
        "cas": dict(mode="cas", stale_prob=0.1, stale_until=8)}
    launches.start()
    rec = {"phase": "counter_nemesis_device_kv", "card": card, "n": n,
           "spec": {"crash": [[s, e, len(ns)] for s, e, ns in spec.crash],
                    "loss_rate": spec.loss_rate,
                    "loss_until": spec.loss_until, "seed": spec.seed},
           "clear_round": clear, "ways": {}}
    finals = {}
    for way, kw in ways.items():
        def make(dev, kw=kw):
            return counter.CounterSim(n, poll_every=2, kv_backend="device",
                                      fault_plan=spec.compile(dev),
                                      device=dev, **kw)

        sim = make(device)
        plan = sim.fault_plan
        ids = torch.arange(n, device=device)
        st0 = sim.add(sim.init_state(), deltas)
        state, wiped, conv = st0, 0, None
        limit = clear + 64 if way == "allreduce" else clear + 16
        while state.t < limit:
            # the acked deltas that die unflushed in an amnesia row
            wiped += int(state.pending[faults.amnesia(plan, state.t,
                                                      ids)].sum())
            state = sim.step(state)
            if way == "allreduce" and state.t >= clear \
                    and int(state.pending.sum()) == 0 \
                    and bool(((state.cached == state.kv)
                              | ~members).all()):
                conv = state.t
                break
        kv = sim.kv_value(state)
        left = int(state.pending.sum(dtype=torch.int64))
        store = int(state.rows.vals[sim._key_at])
        ok = (kv + left + wiped == acked and store == kv
              and (way == "cas" or conv is not None))
        r = {"rounds": state.t, "converged_round": conv, "kv": kv,
             "pending_left": left, "lost_writes_sum": wiped,
             "msgs": int(state.msgs), "ok": ok,
             **{k: v for k, v in kw.items() if k != "mode"},
             **counter_timed(sim, kernels, st0, state.t)}
        rec["ways"][way] = r
        finals[way] = (make, state)
        if not ok:
            raise AssertionError(f"counter_nemesis_device_kv {way}: {r}")
        del sim, st0
    launches.stop(rec, COUNTER_EXPECT)
    for way, (make, state) in finals.items():
        cpu = make("cpu")
        if not same_counter(state, cpu.run(cpu.add(cpu.init_state(),
                                                   deltas), state.t)):
            raise AssertionError(f"counter_nemesis_device_kv {way}: GPU "
                                 "run differs from the CPU path")
        rec["ways"][way]["cpu_match"] = True
    emit(rec)
    del finals
    torch.cuda.empty_cache()


def ids_echo(unique_ids, echo, device, launches: Launches,
             card: str) -> None:
    """Challenges 2 and 1 at 2^20 nodes: ``UniqueIdsSim(max_per_round=32)``
    for 4 rounds, every id distinct (checked on the card) and equal to
    the CPU path; ``EchoSim`` with 4 payload slots a node for 3 rounds,
    ``msgs == 2 valid`` and the replies equal to the CPU path.  No
    kernel: one pass of torch ops a step."""
    import numpy as np
    import torch

    n, g = IDS_ECHO_NODES, 32
    launches.start()
    rng = np.random.default_rng(0)
    sims = [unique_ids.UniqueIdsSim(n, max_per_round=g, device=d)
            for d in (device, "cpu")]
    st, cst = (s.init_state() for s in sims)
    keys, step_ms = [], []
    for _ in range(4):
        counts = rng.integers(0, g + 1, n).astype(np.int32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        st, ids = sims[0].step(st, counts)
        ev[1].record()
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        cst, cids = sims[1].step(cst, counts)
        if not torch.equal(ids.cpu(), cids):
            raise AssertionError("ids_echo: GPU ids differ from the CPU "
                                 "path")
        valid = ids[..., 0] >= 0
        ids = ids.long()
        keys.append(((ids[..., 0] * n + ids[..., 1]) * g
                     + ids[..., 2])[valid])
    allk = torch.cat(keys)
    minted = int(st.minted.sum(dtype=torch.int64))
    distinct = torch.unique(allk).numel() == allk.numel() == minted
    sample = sims[0].format_ids(ids[:8].int())
    rec = {"phase": "ids_echo", "card": card, "n": n,
           "ids": {"max_per_round": g, "rounds": 4, "minted": minted,
                   "all_distinct": distinct, "step_ms": step_ms,
                   "sample": sample[:3]}}
    del keys, allk, ids, cids
    b = 4
    esims = [echo.EchoSim(n, device=d) for d in (device, "cpu")]
    es, ces = (s.init_state() for s in esims)
    n_valid = 0
    for _ in range(3):
        payload = rng.integers(-2**31, 2**31, (n, b)).astype(np.int32)
        valid = rng.random((n, b)) < 0.5
        es, rep = esims[0].step(es, payload, valid)
        ces, crep = esims[1].step(ces, payload, valid)
        if not torch.equal(rep.cpu(), crep):
            raise AssertionError("ids_echo: GPU echo replies differ from "
                                 "the CPU path")
        n_valid += int(valid.sum())
    ok = distinct and int(es.msgs) == 2 * n_valid % (1 << 32) \
        and int(es.msgs) == int(ces.msgs) and st.t == cst.t == 4
    rec["echo"] = {"slots": b, "rounds": 3, "msgs": int(es.msgs),
                   "valid": n_valid}
    rec["ok"] = ok
    launches.stop(rec, ())
    if not ok:
        raise AssertionError(f"ids_echo: {rec}")
    rec["cpu_match"] = True
    emit(rec)
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import (broadcast, counter, echo,
                                                  faults, kernels,
                                                  structured, timing,
                                                  unique_ids)

    device = torch.device("cuda")
    modules = (broadcast, timing)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global OPS_PER_S
    OPS_PER_S = INT_LANES_PER_CLOCK * sms * float(clock.split()[0]) * 1e6
    emit({"phase": "card", "name_power_limit": smi, "sm_clock_max": clock,
          "sms": sms, "int_lanes_per_clock_per_sm": INT_LANES_PER_CLOCK,
          "int_ops_per_s": OPS_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S})

    t0 = time.perf_counter()
    libs = kernels.build()
    for name in libs:
        kernels._lib(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {name: str(lib.relative_to(lib.parents[2]))
                        for name, lib in libs.items()},
          "ptxas": {name: [ln.strip() for ln in
                           lib.with_suffix(".log").read_text().splitlines()
                           if "registers" in ln or "Compiling entry" in ln]
                    for name, lib in libs.items()}})

    errs = check_kernels(kernels, structured, topology, device)
    times = time_kernels(kernels, structured, topology, device)
    emit({"phase": "kernel_check", "tolerance": 0, "max_abs_err": errs,
          "shapes": [list(s) for s in CHECK_SHAPES + MAIN_SHAPES],
          "shift_edge_shapes": [list(s) for s in
                                shift_edges(kernels.SHIFT_TILE)],
          "shift_view_offsets": [0, 1],
          "gather_edge_shapes": [list(s) for s in gather_edges(
              kernels.gather_nodes_per_block)],
          "gather_view_offsets": [0, 1],
          "shift_modes": [m[0] for m in shift_modes(N_NODES, topology)],
          "tree_vec_ns": list(TREE_VEC_NS),
          "ring_shapes": [list(s) for s in
                          CHECK_SHAPES + RING_SHAPES + MAIN_SHAPES],
          "coin_dir_sets": [name for name, _ in coin_dir_sets(
              structured, topology, N_NODES)],
          "counter_ns": list(COUNTER_NS),
          "times": {k: {f"{w}x{n}": v for (w, n), v in t.items()}
                    for k, t in times.items()}})

    launches = Launches(kernels)
    tree_kw = {"branching": BRANCHING}
    w1_structured("w1_tree", "tree", tree_kw, BRANCHING + 1,
                  ("tree_flood_round", "tree_exchange", "col_popcount"),
                  modules, device, launches, want_rounds=13)
    w128_structured("w128_tree", "tree", lambda n: tree_kw, BRANCHING + 1,
                    ("tree_flood_round", "col_popcount"), modules, device,
                    launches, want_rounds=16)

    def circ_kw(n):
        return {"strides": topology.expander_strides(n, DEGREE, seed=0)}

    w1_structured("w1_circulant", "circulant", circ_kw(N_NODES), DEGREE,
                  ("shift_flood_round", "shift_exchange", "col_popcount",
                   "gather_flood_round", "col_popcount_nm"),
                  modules, device, launches,
                  gather_nbrs=topology.circulant(
                      N_NODES, circ_kw(N_NODES)["strides"]))
    w128_structured("w128_circulant", "circulant", circ_kw, DEGREE,
                    ("shift_flood_round", "col_popcount"), modules, device,
                    launches)
    gather_phases(modules, topology, device, launches)
    nemesis_phases(modules, faults, topology, device, launches)
    structured_fault_phases(modules, faults, structured, kernels, topology,
                            device, launches)
    delay_phases(modules, faults, structured, kernels, topology, device,
                 launches)
    small_floods(modules, device, launches)
    counter_phases(counter, faults, kernels, device, launches, smi)
    ids_echo(unique_ids, echo, device, launches, smi)

    for name, count in launches.total.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
    print(smi, flush=True)
    entries = []
    for name, (source, replaces, _) in KERNELS.items():
        shapes = times[name]
        big = max(shapes, key=lambda s: s[0] * s[1])
        entry = {"name": name, "route": "cuda", "source": CSRC + source,
                 "replaces": replaces, "launches": launches.total[name],
                 "max_abs_err": errs[name], **shapes[big],
                 "library_ms": None, "at": list(big)}
        if MAIN_SHAPES[0] in shapes and big != MAIN_SHAPES[0] \
                and not name.startswith("counter_"):
            entry["w1"] = shapes[MAIN_SHAPES[0]]
        elif len(shapes) > 1:   # wm_fault_coins (D, N), the counter (1, N)
            entry["also"] = {f"{w}x{n}": v for (w, n), v in shapes.items()
                             if (w, n) != big}
        if name.startswith("shift_"):
            entry["launches_by_path"] = launches.split(name)
        entries.append(entry)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
