"""Hand-written CUDA kernels of the broadcast floods, their wrappers and
their plain PyTorch versions.

Eight sources in ``csrc/`` (each header notes what its kernels replace,
what bounds them on an H100 and what the design does about it):

- ``tree_flood.cu``, the words-major k-ary tree:
  :func:`tree_exchange` (the port of the Pallas kernel in
  benchmarks/pallas_tree_probe.py), its masked form
  :func:`tree_masked_exchange` (partitions and the nemesis), its ring
  mode :func:`tree_ring_exchange` (per-hop delays: each term from its
  own slot of the payload history ring),
  :func:`tree_flood_round` (one fused pure-flood round, ``new =
  exchange(frontier) & ~received; received |= new; frontier_next =
  new``), :func:`col_popcount` (per-node popcount sums ``sum_w
  popc(x[w, i])``) and the halo exchange's shard-local pair on a mesh:
  :func:`tree_halo_pack` (the child partial a shard sends its parent
  shard) and :func:`tree_halo_round` (the inbox from the received
  parent slice and kids' partials, alone or as the fused flood round);
- ``shift_flood.cu``, the words-major shift topologies (circulant, ring,
  line, grid): :func:`shift_exchange`, its masked form
  :func:`shift_masked_exchange`, its ring mode
  :func:`shift_ring_exchange` (each direction from its own slot of the
  payload history ring) and :func:`shift_flood_round`, all driven by a
  :class:`ShiftDirs` direction table, whose tiles stage the source
  windows of :func:`shift_windows` in shared memory;
- ``gather_flood.cu``, the node-major adjacency gather:
  :func:`gather_or`, :func:`gather_flood_round` (one fused gather round,
  ``new = gather_or(payload) & ~rec``, ``rec_next = rec | new``, out of
  place), :func:`sync_diff_pc` and the node-major mode of
  :func:`col_popcount`;
- ``fault_flood.cu``, the faulted gather round under a nemesis plan:
  :func:`fault_coins` (one flag byte an edge: sent, delivered,
  duplicated, reply not lost) and :func:`faulted_gather_round` (the
  gather round over those flags, with the dup ledger charge), each with
  a scenario-batch form (``table=`` / ``block=``: S scenarios folded
  into S N rows, per-scenario coins and dup charges), the batch's
  in-place freeze :func:`fold_freeze`; and the words-major nemesis's
  coins, :func:`wm_fault_coins`;
- ``counter_round.cu``, the g-counter's round: :func:`counter_select`
  (the read pass: the CAS winner or the flushed sum, the message count,
  finalized on the card into the round's new ``kv`` and ``msgs``) and
  :func:`counter_apply` (the update pass: drain ``pending``, refresh
  ``cached``);
- ``kafka_round.cu``, the replicated log's round over its (N, K, Wc)
  presence and (N, K) committed-offset cache, in place:
  :func:`kafka_merge` (amnesia wipe, delivery, high-water mark, the
  resync union), :func:`kafka_nem_deliver` (the faulted origin union of
  a slab of destination rows), :func:`kafka_commit_select` (the resync
  take and the commit classification, with the per-key CAS and writer
  winners) and :func:`kafka_commit_apply` (the learned offsets, the new
  cells and the message ledger);
- ``traffic_fold.cu``, the open-loop traffic drivers' completion
  predicate: :func:`and_fold` (the AND over the node axis of a bitset,
  words-major or node-major);
- ``prov_flood.cu``, the causal provenance record of the gather round:
  :func:`prov_attribute` (each newly delivered bit's arrival round and
  the neighbour whose delivery carried it first, in place);
- ``txn_round.cu``, the txn-rw-register round's wound-or-die pair:
  :func:`txn_claim` (each key's best claim priority, and the round's
  attempts) and :func:`txn_commit` (the winner test, the winners' reads,
  records and write requests, the node counters, in place).

The masked structured exchanges and the words-major coins take their
per-direction liveness as packed rows (:func:`pack_bits`): (D, ceil(N /
32)) int32, node i at bit i % 32 of word i // 32 — at W = 1 a bool row
would move as many bytes as the bitset it gates.

Bitsets are ``torch.int32`` tensors holding the reference's uint32 words
bit for bit: (W, N) words-major, (N, W) node-major.  A wrapper takes its
plain version only when its tensors lie on the CPU; on CUDA tensors it
launches the kernel or raises.  Each source is compiled with ``nvcc`` on
first CUDA use (never at import, so this module imports on machines
without a toolkit) into ``build/gossip_glomers_tpu_torch/`` beside the
package, keyed by a hash of that source and the flags, and loaded with
``ctypes``; :func:`build` compiles every source at once, one ``nvcc``
process each.

:data:`LAUNCHES` counts kernel launches per entry point (CPU calls do not
count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("tree_flood", "shift_flood", "gather_flood",
                        "fault_flood", "counter_round", "kafka_round",
                        "traffic_fold", "prov_flood", "txn_round")}
BUILD_DIR = _PKG.parent / "build" / "gossip_glomers_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_WORDS = 65535            # grid.y carries the word axis (words-major)
MAX_DIRS = 16                # shift_flood.cu's kMaxDirs: a group's
MAX_RING_ROWS = 32           # and kMaxRows: a ring table's rows a launch
MAX_RING_ENTRIES = 16        # tree_flood.cu's kMaxEntries
MASK32 = 0xFFFFFFFF
# shift_flood.cu's tiles: nodes per tile at most, stages in flight per
# block (2 measured faster than 3 for the circulant's fused round on an
# H100, and no slower for the ring's groups; PERF.md), and the dynamic
# shared memory a block may take
# (kMaxSmemBytes)
SHIFT_TILE = 2048
SHIFT_STAGES = 2
SHIFT_SMEM_BYTES = 227 * 1024 - 1024
MAX_NODES = (1 << 31) - 1    # gather_flood.cu's node indices are int32
GATHER_THREADS = 256         # gather_flood.cu's kThreads

# direction flags of a ShiftDirs table (shift_flood.cu)
WRAP, MASK_LEFT, MASK_RIGHT = 1, 2, 4
# the edge flags of fault_coins (fault_flood.cu): a send is charged, the
# delivery survived the loss coin, the dup coin fired, the reply's coin
FLAG_SEND, FLAG_DEL, FLAG_DUP, FLAG_OUT_OK = 1, 2, 4, 8
# the term kinds of a tree_ring_exchange table (tree_flood.cu RingTable)
TREE_PARENT, TREE_KIDS = 0, 1
# the id forms of wm_fault_coins' direction descriptors (fault_flood.cu):
# i; (i + off) mod n; (i - 1) // k; k * i + 1 + j
COIN_IDENT, COIN_SHIFT, COIN_PARENT, COIN_CHILD = 0, 1, 2, 3
# the counter round's per-node gate byte (counter_round.cu): the node
# cannot reach the KV this round; its pending and cached are wiped first
GATE_BLOCKED, GATE_WIPE = 1, 2
# the counter round's work words (counter_round.cu Work): the winner key,
# two pairs of 32-bit counters, and the round's winner row (word 3)
COUNTER_WORK_WORDS = 4
# the Kafka round's resync modes (kafka_round.cu): none, the pull of the
# live rows' presence, the push of the live origins' durable bits
RESYNC_NONE, RESYNC_PULL, RESYNC_PUSH = 0, 1, 2
# kafka_round.cu's kMaxWords: presence words a key (capacity <= 1536)
KAFKA_MAX_WORDS = 48
# the Kafka commit pass's counters (kafka_commit_select): active dances,
# KV-blocked dances, write legs, resync tallies (takes or pushers)
KAFKA_COUNTS = 4

LAUNCHES = {"tree_exchange": 0, "tree_masked_exchange": 0,
            "tree_flood_round": 0, "col_popcount": 0,
            "col_popcount_nm": 0, "shift_exchange": 0,
            "shift_masked_exchange": 0, "shift_flood_round": 0,
            "gather_or": 0, "sync_diff_pc": 0, "gather_flood_round": 0,
            "fault_coins": 0, "faulted_gather_round": 0,
            "fault_coins_batched": 0, "faulted_gather_round_batched": 0,
            "fold_freeze": 0,
            "wm_fault_coins": 0, "tree_ring_exchange": 0,
            "shift_ring_exchange": 0, "counter_select": 0,
            "counter_apply": 0, "kafka_merge": 0, "kafka_nem_deliver": 0,
            "kafka_commit_select": 0, "kafka_commit_apply": 0,
            "and_fold": 0, "prov_attribute": 0, "txn_claim": 0,
            "txn_commit": 0, "tree_halo_pack": 0, "tree_halo_round": 0}

_lib_handles: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class ShiftDirs:
    """A shift topology's direction table: node i's inbox is the OR over
    directions d of ``payload[:, i + offs[d]]`` — mod n where ``flags[d]``
    has :data:`WRAP` (offsets in [0, n)), else only inside [0, n) — kept
    only where ``i % cols < cols - 1`` (:data:`MASK_LEFT`) or
    ``i % cols > 0`` (:data:`MASK_RIGHT`) when those flags are set.
    ``slots``, a ring table's (:func:`shift_ring_exchange`): the slot of
    the (L, W, N) payload ring each direction reads; empty for one (W, N)
    source."""

    offs: tuple[int, ...]
    flags: tuple[int, ...]
    cols: int = 0
    slots: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ShiftWindow:
    """Source words the shift kernels stage together: for the tile of
    nodes [i0, i0 + tl) of a row, positions [i0 + lo, i0 + hi + tl) —
    taken mod n when ``wrap``, else zero outside [0, n), of ring slot
    ``slot`` (0 for one source).  Direction d of ``dirs`` reads it at
    ``signed_offset(d) - lo``."""

    lo: int
    hi: int
    wrap: bool
    dirs: tuple[int, ...]
    slot: int = 0


def signed_offset(off: int, flags: int, n: int) -> int:
    """A direction's offset as the windows take it: a wrap offset (in
    [0, n)) as its representative nearest 0, a zero-fill one as is."""
    return off - n if flags & WRAP and 2 * off > n else off


def shift_windows(dirs: ShiftDirs, n: int,
                  tile: int) -> tuple[ShiftWindow, ...]:
    """The shift kernels' windows for tiles of ``tile`` nodes: the
    directions sorted by signed offset, ring slot, wrap and zero-fill
    apart, and every run whose spread is at most ``tile`` merged into one
    window (one window of ``spread + tile`` words costs no more than two
    of ``tile``).  The circulant at 2^20 nodes has 7 (its ±1 pair merges),
    ring and line 1, the 1024-column grid 1; a ring table as many again
    for every slot it reads."""
    def slot(d: int) -> int:
        return dirs.slots[d] if dirs.slots else 0

    order = sorted(range(len(dirs.offs)), key=lambda d: (
        slot(d), bool(dirs.flags[d] & WRAP),
        signed_offset(dirs.offs[d], dirs.flags[d], n)))
    windows: list[ShiftWindow] = []
    for d in order:
        wrap = bool(dirs.flags[d] & WRAP)
        o = signed_offset(dirs.offs[d], dirs.flags[d], n)
        last = windows[-1] if windows else None
        if last is not None and (last.slot, last.wrap) == (slot(d), wrap) \
                and o - last.lo <= tile:
            windows[-1] = ShiftWindow(last.lo, o, wrap, last.dirs + (d,),
                                      last.slot)
        else:
            windows.append(ShiftWindow(o, o, wrap, (d,), slot(d)))
    return tuple(windows)


def _check_dirs(dirs: ShiftDirs, n: int) -> None:
    if len(dirs.offs) != len(dirs.flags):
        raise ValueError("ShiftDirs offs and flags differ in length")
    most = MAX_RING_ROWS if dirs.slots else MAX_DIRS
    if len(dirs.offs) > most:
        raise ValueError(f"{len(dirs.offs)} directions exceed the shift "
                         f"kernels' {most}")
    for off, flags in zip(dirs.offs, dirs.flags):
        if flags & WRAP and not 0 <= off < n:
            raise ValueError(f"wrap offset {off} outside [0, {n})")
        if flags & (MASK_LEFT | MASK_RIGHT) and dirs.cols < 1:
            raise ValueError("a column mask needs cols >= 1")
    if dirs.slots and (len(dirs.slots) != len(dirs.offs)
                       or min(dirs.slots) < 0):
        raise ValueError("a ring table needs a slot >= 0 a direction")


def shift_groups(dirs: ShiftDirs, n: int) -> tuple[tuple[int, ...], ...]:
    """The directions a stage of the shift kernels holds together: one
    group of a one-source table (in table order), and for a ring table
    the directions sorted as :func:`shift_windows` sorts them (slot
    first), cut at every new slot and after every :data:`MAX_DIRS`."""
    if not dirs.slots:
        return (tuple(range(len(dirs.offs))),)
    order = sorted(range(len(dirs.offs)), key=lambda d: (
        dirs.slots[d], bool(dirs.flags[d] & WRAP),
        signed_offset(dirs.offs[d], dirs.flags[d], n)))
    groups: list[list[int]] = []
    for d in order:
        if groups and dirs.slots[groups[-1][0]] == dirs.slots[d] \
                and len(groups[-1]) < MAX_DIRS:
            groups[-1].append(d)
        else:
            groups.append([d])
    return tuple(tuple(g) for g in groups)


def _group_windows(dirs: ShiftDirs, group: tuple[int, ...], n: int,
                   tile: int) -> tuple[ShiftWindow, ...]:
    """:func:`shift_windows` of the group's directions, naming them by
    their rows of ``dirs``."""
    sub = ShiftDirs(tuple(dirs.offs[d] for d in group),
                    tuple(dirs.flags[d] for d in group), dirs.cols,
                    tuple(dirs.slots[d] for d in group) if dirs.slots
                    else ())
    return tuple(dataclasses.replace(win, dirs=tuple(group[j]
                                                     for j in win.dirs))
                 for win in shift_windows(sub, n, tile))


def _round4(x: int) -> int:
    return (x + 3) & ~3


def live_slot_words(tile: int) -> int:
    """Words of one liveness row's slot in a masked plan's stage: a
    tile's slice of (tile + 31) // 32 + 1 packed words at most (at any
    tile start), at its 16-byte phase, in whole 16-byte units."""
    return _round4((tile + 62) // 32 + 3)


@functools.lru_cache(maxsize=256)
def _shift_plan(dirs: ShiftDirs, n: int, fused: bool,
                max_tile: int = SHIFT_TILE, live: bool = False):
    """(ctypes int64 words, count) of shift_flood.cu's Plan for one table
    at n nodes, checked and built once per (table, n, mode) so that a
    launch repeats neither; raises ValueError for a table the kernels
    cannot take.  A stage holds one group of :func:`shift_groups` — its
    windows at their 16-byte phase, then the received tile in the fused
    round or, with ``live`` (the masked exchange), one
    :func:`live_slot_words` slot a direction of the group for its
    liveness slice — and is as large as the largest group's.  The tile
    is the largest (at most ``max_tile``, :data:`SHIFT_TILE` and n) whose
    stage fits :data:`SHIFT_STAGES` times in shared memory.
    Layout: tile, stages, stage words, received's offset, cols, windows,
    directions, the liveness slots' offset (-1: none; a ring plan's first
    group's); per window lo, hi - lo, wrap, offset in its group's stage;
    per direction, grouped, window, offset - lo, mask flags.  A ring table
    (``dirs.slots``) goes on with the number of groups, per group its
    slot, first window, windows, first direction, directions and liveness
    offset (-1: none), and per direction its row of the table (its
    liveness row).  The liveness slot's words are ``(stage words - the
    liveness offset) / directions`` in a one-source plan and follow the
    number of groups in a ring plan (0: none)."""
    if fused and live:
        raise ValueError("the fused round takes no liveness rows")
    _check_dirs(dirs, n)
    groups = shift_groups(dirs, n)
    tile = min(max_tile, n, SHIFT_TILE)
    while True:
        windows = [_group_windows(dirs, g, n, tile) for g in groups]
        sizes = [[_round4(w.hi - w.lo + tile + 3) for w in wins]
                 for wins in windows]
        ends = [sum(sz) for sz in sizes]
        extra = [(_round4(tile + 3) if fused else 0)
                 + (len(g) * live_slot_words(tile) if live else 0)
                 for g in groups]
        stage = max(e + x for e, x in zip(ends, extra))
        if SHIFT_STAGES * 4 * stage <= SHIFT_SMEM_BYTES or tile == 1:
            break
        tile = (tile + 1) // 2
    live_at = [end if live else -1 for end in ends]
    words = [tile, SHIFT_STAGES, stage, ends[0] if fused else -1, dirs.cols,
             sum(len(w) for w in windows), len(dirs.offs), live_at[0]]
    first = 0
    where = {}
    for wins, sz in zip(windows, sizes):
        for k, win in enumerate(wins):
            words += [win.lo, win.hi - win.lo, int(win.wrap), sum(sz[:k])]
            for d in win.dirs:
                where[d] = (first + k, win.lo)
        first += len(wins)
    for d in (d for g in groups for d in g):
        k, lo = where[d]
        off, flags = dirs.offs[d], dirs.flags[d]
        words += [k, signed_offset(off, flags, n) - lo,
                  flags & (MASK_LEFT | MASK_RIGHT)]
    if dirs.slots:
        words += [len(groups), live_slot_words(tile) if live else 0]
        win0 = dir0 = 0
        for g, wins, at in zip(groups, windows, live_at):
            words += [dirs.slots[g[0]], win0, len(wins), dir0, len(g), at]
            win0 += len(wins)
            dir0 += len(g)
        words += [d for g in groups for d in g]
    return (ctypes.c_int64 * len(words))(*words), len(words)


# -- packed liveness rows ------------------------------------------------


def packed_words(n: int) -> int:
    """Words of a packed row over ``n`` nodes."""
    return (n + 31) // 32


def pack_bits(rows: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., ceil(N/32)) int32: node i at bit i % 32 of
    word i // 32, the bits past N zero."""
    n = rows.shape[-1]
    nw = packed_words(n)
    pad = rows.new_zeros(rows.shape[:-1] + (nw * 32 - n,))
    bits = torch.cat([rows, pad], dim=-1).reshape(
        rows.shape[:-1] + (nw, 32)).to(torch.int64)
    v = (bits << torch.arange(32, device=rows.device)).sum(dim=-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., ceil(n/32)) int32 packed rows -> (..., n) bool."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words[..., None] >> shifts) & 1).flatten(-2)[..., :n].bool()


def count_rows(words: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64: per node, how many of the (D, ceil(n/32)) packed rows
    hold its bit — a live degree."""
    return unpack_bits(words, n).sum(dim=0, dtype=torch.int64)


# -- plain versions ------------------------------------------------------


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (the reference's
    ``lax.population_count`` on uint32), as int32.  On the CPU numpy's
    ``bitwise_count`` where it has one (numpy 2); else SWAR in int32 on
    the low 31 bits, so every value stays non-negative (each shift is
    logical and no step overflows), plus the sign bit."""
    if x.device.type == "cpu" and hasattr(np, "bitwise_count"):
        return torch.from_numpy(np.bitwise_count(
            x.numpy().view(np.uint32))).to(torch.int32)
    return popcount_swar(x)


def popcount_swar(x: torch.Tensor) -> torch.Tensor:
    """:func:`popcount` by torch ops on any device."""
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + (x < 0).to(torch.int32)


def col_popcount_plain(x: torch.Tensor,
                       node_major: bool = False) -> torch.Tensor:
    return popcount(x).sum(dim=1 if node_major else 0, dtype=torch.int32)


def tree_exchange_plain(payload: torch.Tensor,
                        branching: int = 4) -> torch.Tensor:
    # structured imports this module for its exchange closures
    from .structured import tree_exchange as plain

    return plain(payload, branching)


def tree_masked_exchange_plain(payload: torch.Tensor,
                               live_parent: torch.Tensor,
                               live_kids: torch.Tensor,
                               branching: int = 4) -> torch.Tensor:
    from .structured import tree_masked_terms

    n = payload.shape[1]
    return tree_masked_terms(payload, unpack_bits(live_parent, n),
                             unpack_bits(live_kids, n), branching)


def tree_flood_round_plain(received: torch.Tensor, frontier: torch.Tensor,
                           frontier_next: torch.Tensor,
                           branching: int = 4) -> torch.Tensor:
    new = tree_exchange_plain(frontier, branching) & ~received
    received |= new
    frontier_next.copy_(new)
    return frontier_next


def _live_cols(x: torch.Tensor, live: torch.Tensor | None) -> torch.Tensor:
    """``x`` with the columns whose bit of the packed row ``live`` is
    clear zeroed (``x`` itself for None)."""
    if live is None:
        return x
    return torch.where(unpack_bits(live, x.shape[1])[None, :], x, 0)


def tree_halo_pack_plain(payload: torch.Tensor, branching: int = 4,
                         live: torch.Tensor | None = None) -> torch.Tensor:
    """The child partial of a (W, B) block (the reference's
    ``tree_kids_payload``, structured.py:303-309): column 0 passed
    through, then column j >= 1 the OR of columns k(j-1)+1 .. kj (those
    below B), the block's columns first masked by the packed row
    ``live`` where given.  (W, B/k + 1)."""
    w, b = payload.shape
    k = branching
    sub = b // k
    x = _live_cols(payload, live)
    body = torch.cat([x[:, 1:], x.new_zeros(w, sub * k - (b - 1))], dim=1)
    groups = functools.reduce(torch.bitwise_or,
                              body.view(w, sub, k).unbind(dim=2))
    return torch.cat([x[:, :1], groups], dim=1)


def tree_halo_round_plain(buf: torch.Tensor, ek: torch.Tensor,
                          back: torch.Tensor | None, branching: int = 4,
                          live: torch.Tensor | None = None,
                          received: torch.Tensor | None = None,
                          frontier_next: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The halo tree inbox of a (W, B) block (structured.py:249-252 and
    :322-327): ``inbox[:, c] = buf[:, ceil(c/k)] | ek[:, c+1]``, the
    parent term masked by the packed row ``live`` where given and the
    back-folded column ``back`` (W,) ORed into column B - 1.  With
    ``received`` the fused flood round: ``new = inbox & ~received``,
    ``received |= new`` in place, ``frontier_next[:] = new``."""
    w = buf.shape[0]
    b = ek.shape[1] - 1
    k = branching
    idx = (torch.arange(b, device=buf.device) + k - 1) // k
    inbox = _live_cols(buf[:, idx], live) | ek[:, 1:]
    if back is not None:
        inbox[:, b - 1] |= back.reshape(w)
    if received is None:
        return inbox
    new = inbox & ~received
    received |= new
    frontier_next.copy_(new)
    return frontier_next


def _shifted(payload: torch.Tensor, off: int, wrap: bool) -> torch.Tensor:
    """out[:, i] = payload[:, i + off], mod n or zero-filled outside."""
    w, n = payload.shape
    if wrap:
        return torch.roll(payload, -off, dims=1)
    k = min(abs(off), n)
    zeros = payload.new_zeros(w, k)
    if off >= 0:
        return torch.cat([payload[:, k:], zeros], dim=1)
    return torch.cat([zeros, payload[:, :n - k]], dim=1)


def shift_term_plain(payload: torch.Tensor, dirs: ShiftDirs,
                     d: int) -> torch.Tensor:
    """Direction d's term of the shift exchange: ``payload[:, i +
    offs[d]]`` (mod n or zero-filled), under its column mask.  Any
    integer (W, N) tensor: the nemesis relocates popcounts with it."""
    flags = dirs.flags[d]
    term = _shifted(payload, dirs.offs[d], bool(flags & WRAP))
    if flags & (MASK_LEFT | MASK_RIGHT):
        col = torch.arange(payload.shape[1], device=payload.device) \
            % dirs.cols
        keep = (col < dirs.cols - 1 if flags & MASK_LEFT else col > 0)
        term = torch.where(keep[None, :], term, 0)
    return term


def shift_exchange_plain(payload: torch.Tensor,
                         dirs: ShiftDirs) -> torch.Tensor:
    out = torch.zeros_like(payload)
    for d in range(len(dirs.offs)):
        out |= shift_term_plain(payload, dirs, d)
    return out


def shift_masked_exchange_plain(payload: torch.Tensor, live: torch.Tensor,
                                dirs: ShiftDirs) -> torch.Tensor:
    lv = unpack_bits(live, payload.shape[1])
    out = torch.zeros_like(payload)
    for d in range(len(dirs.offs)):
        out |= torch.where(lv[d][None, :], shift_term_plain(payload, dirs, d),
                           0)
    return out


def shift_ring_exchange_plain(ring: torch.Tensor, dirs: ShiftDirs,
                              live: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """The reference's delayed composition: each direction's term of its
    ring slot (a roll or shift), masked at receivers by its packed row of
    ``live`` when given, ORed."""
    lv = None if live is None else unpack_bits(live, ring.shape[2])
    out = ring.new_zeros(ring.shape[1:])
    for d, slot in enumerate(dirs.slots):
        term = shift_term_plain(ring[slot], dirs, d)
        out |= term if lv is None else torch.where(lv[d][None, :], term, 0)
    return out


def tree_ring_exchange_plain(ring: torch.Tensor, table,
                             live: torch.Tensor | None = None,
                             branching: int = 4) -> torch.Tensor:
    """The reference's delayed composition: per (slot, kind, row) entry,
    the from-parent repeat of the slot masked at receivers, or the
    from-kids fold of the slot masked at child positions before the fold
    (row -1: no mask), ORed."""
    from .structured import _mask_cols, tree_from_kids, tree_from_parent

    n = ring.shape[2]
    lv = None if live is None else unpack_bits(live, n)
    out = ring.new_zeros(ring.shape[1:])
    if n == 1:
        return out
    for slot, kind, row in table:
        p = ring[slot]
        if kind == TREE_PARENT:
            term = tree_from_parent(p, branching)
            out |= term if row < 0 else _mask_cols(term, lv[row])
        else:
            out |= tree_from_kids(p if row < 0 else _mask_cols(p, lv[row]),
                                  branching)
    return out


def shift_flood_round_plain(received: torch.Tensor, frontier: torch.Tensor,
                            frontier_next: torch.Tensor,
                            dirs: ShiftDirs) -> torch.Tensor:
    new = shift_exchange_plain(frontier, dirs) & ~received
    received |= new
    frontier_next.copy_(new)
    return frontier_next


def _edges(nbrs: torch.Tensor, live: torch.Tensor | None, n_src: int):
    """(per-edge deliver mask, clipped int64 indices): the reference
    clips every index into [0, n_src) and then masks."""
    ok = nbrs >= 0 if live is None else live
    return ok, nbrs.clamp(0, n_src - 1).to(torch.int64)


def gather_or_plain(payload: torch.Tensor, nbrs: torch.Tensor,
                    live: torch.Tensor | None = None) -> torch.Tensor:
    ok, idx = _edges(nbrs, live, payload.shape[0])
    out = payload.new_zeros(nbrs.shape[0], payload.shape[1])
    for d in range(nbrs.shape[1]):
        out |= torch.where(ok[:, d, None], payload[idx[:, d]], 0)
    return out


def gather_flood_round_plain(payload: torch.Tensor, rec: torch.Tensor,
                             nbrs: torch.Tensor,
                             live: torch.Tensor | None = None):
    new = gather_or_plain(payload, nbrs, live) & ~rec
    return new, rec | new


def sync_diff_pc_plain(payload: torch.Tensor, recv: torch.Tensor,
                       nbrs: torch.Tensor,
                       live: torch.Tensor | None = None) -> torch.Tensor:
    ok, idx = _edges(nbrs, live, payload.shape[0])
    total = torch.zeros((), dtype=torch.int64, device=payload.device)
    for d in range(nbrs.shape[1]):
        per = popcount(payload[idx[:, d]] & ~recv).sum(dim=1,
                                                      dtype=torch.int64)
        total = total + torch.where(ok[:, d], per, 0).sum()
    return total & MASK32


def fault_coins_plain(nbrs: torch.Tensor, up: torch.Tensor, *, t: int,
                      seed: int = 0, loss_num: int = 0, dup_num: int = 0,
                      loss: bool = False, dup: bool = False,
                      out_ok: bool = False,
                      live: torch.Tensor | None = None,
                      row0: int = 0, table: torch.Tensor | None = None,
                      block: int = 0) -> torch.Tensor:
    # faults imports nothing of this module; its hash is the coins' one
    from .faults import _SALT_DUP, _SALT_LOSS, _hash32

    rows = torch.arange(row0, row0 + nbrs.shape[0],
                        device=nbrs.device)[:, None]
    base = 0
    if table is None:
        block, loss, dup = up.shape[0], bool(loss), bool(dup)
    else:
        base = rows // block * block
        tab = table[rows[:, 0] // block]
        seed, loss_num, dup_num = tab[:, 0:1], tab[:, 1:2], tab[:, 2:3]
        loss, dup = tab[:, 3:4] != 0, tab[:, 4:5] != 0
    dst = rows - base
    src = torch.where(nbrs < 0, 0,
                      (nbrs.to(torch.int64) - base).clamp(0, block - 1))
    ok = nbrs >= 0 if live is None else live
    send = ok & up[rows] & up[base + src]

    def kept(a, b):
        """The loss coin of a -> b did not drop (every edge where the
        stream is off)."""
        if loss is False:
            return torch.ones_like(send)
        return ~torch.as_tensor(loss) \
            | (_hash32(seed, t, a, b, _SALT_LOSS) >= loss_num)

    deliver = send & kept(src, dst)
    flags = send.to(torch.uint8) * FLAG_SEND + deliver.to(torch.uint8) \
        * FLAG_DEL
    if dup is not False:
        fired = deliver & dup & (_hash32(seed, t, src, dst, _SALT_DUP)
                                 < dup_num)
        flags += fired.to(torch.uint8) * FLAG_DUP
    if out_ok:
        flags += kept(dst, src).to(torch.uint8) * FLAG_OUT_OK
    return flags


def faulted_gather_round_plain(payload: torch.Tensor,
                               received: torch.Tensor | None,
                               rec: torch.Tensor, nbrs: torch.Tensor,
                               flags: torch.Tensor, block: int = 0):
    inbox = gather_or_plain(payload, nbrs, (flags & FLAG_DEL) != 0)
    shape = (nbrs.shape[0] // block,) if block else ()
    dup_pc = torch.zeros(shape, dtype=torch.int64, device=payload.device)
    if received is not None:
        dup = (flags & FLAG_DUP) != 0
        inbox |= gather_or_plain(received, nbrs, dup)
        pc_src = col_popcount_plain(received, node_major=True)
        src = nbrs.clamp(0, received.shape[0] - 1).to(torch.int64)
        per_row = torch.where(dup, pc_src[src], 0).sum(dim=1,
                                                     dtype=torch.int64)
        dup_pc = (per_row.view(-1, block).sum(dim=1) if block
                  else per_row.sum()) & MASK32
    new = inbox & ~rec
    return new, rec | new, dup_pc


def fold_freeze_plain(dst: torch.Tensor, src: torch.Tensor,
                      active: torch.Tensor, block: int,
                      dst1: torch.Tensor | None = None,
                      src1: torch.Tensor | None = None) -> None:
    rows = active[:, None].expand(-1, block).reshape(-1, 1)
    dst.copy_(torch.where(rows, src, dst))
    if dst1 is not None:
        dst1.copy_(torch.where(rows, src1, dst1))


def wm_fault_coins_plain(src: torch.Tensor, dst: torch.Tensor,
                        live: torch.Tensor, *, t: int, seed: int,
                        loss_num: int, dup_num: int, loss: bool, dup: bool,
                        srv: bool):
    from .faults import _SALT_DUP, _SALT_LOSS, _hash32

    lv = unpack_bits(live, src.shape[1])
    s, r = src.to(torch.int64), dst.to(torch.int64)

    def kept(a, b):
        return (_hash32(seed, t, a, b, _SALT_LOSS) >= loss_num if loss
                else torch.ones_like(lv))

    if srv:
        ack = lv & kept(r, s)
        return pack_bits(ack), pack_bits(ack & kept(s, r))
    deliver = lv & kept(s, r)
    if not dup:
        return pack_bits(deliver), None
    fired = deliver & (_hash32(seed, t, s, r, _SALT_DUP) < dup_num)
    return pack_bits(deliver), pack_bits(fired)


# the counter round's hash (counter.py's winner priority) and the seq-kv
# stale coin's key terms (kvstore.stale_coin)
_K_ROW, _K_ROUND = 0x9E3779B9, 0x85EBCA6B
_K_PRI1 = 0x7FEB352D
_NO_KEY = (1 << 63) - 1      # the unsigned all-ones key, shifted by 2^63


def _gated(pending: torch.Tensor, cached: torch.Tensor,
           gate: torch.Tensor | None):
    """(pending, cached, reach) after the gate byte: wiped rows read 0,
    blocked rows do not reach the KV (None: every row does)."""
    if gate is None:
        return pending, cached, None
    wipe = (gate & GATE_WIPE) != 0
    return (torch.where(wipe, 0, pending), torch.where(wipe, 0, cached),
            (gate & GATE_BLOCKED) == 0)


def counter_priority(n: int, t: int, seed: int, *, wide: bool,
                     row_bits: int, device=None,
                     row0: int = 0) -> torch.Tensor:
    """(n,) int64: the CAS winner's hashed priority of each row (the
    global rows ``row0 .. row0 + n - 1``) at round ``t``: ``min(x, 2^32 -
    2)`` in the wide layout, the top ``31 - row_bits`` bits of x capped at
    all-ones less one in the packed one."""
    from .faults import _mul32

    rows = row0 + torch.arange(n, dtype=torch.int64, device=device)
    x = (_mul32(rows, _K_ROW)
         + ((((t + seed) & MASK32) * _K_ROUND) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _K_PRI1)
    x = x ^ (x >> 15)
    if wide:
        return x.clamp(max=MASK32 - 1)
    pri_bits = 31 - row_bits
    return (x >> (32 - pri_bits)).clamp(max=(1 << pri_bits) - 2)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32, wrapping mod 2^32 as int32 sums do."""
    x = x & MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def counter_select_plain(pending: torch.Tensor, cached: torch.Tensor,
                         gate: torch.Tensor | None, kv0: torch.Tensor,
                         msgs: torch.Tensor, work: torch.Tensor, *,
                         cas: bool, wide: bool, row_bits: int, t: int,
                         seed: int, poll: bool, row0: int = 0,
                         partial: bool = False):
    n = pending.shape[0]
    p, c, reach = _gated(pending, cached, gate)
    if reach is None:
        reach = torch.ones_like(p, dtype=torch.bool)
    want = (p > 0) & reach
    polled = reach if poll else torch.zeros_like(reach)
    if partial:
        return _counter_partial_plain(p, c, want, polled, kv0, cas=cas,
                                      wide=wide, row_bits=row_bits, t=t,
                                      seed=seed, row0=row0)
    if cas:
        # the winner: the least (priority, row) among the fresh-read
        # contenders, as one 64-bit key (priority high, row low) moved
        # into int64 by subtracting 2^63, which keeps its order
        rows = torch.arange(n, dtype=torch.int64, device=p.device)
        pri = counter_priority(n, t, seed, wide=wide, row_bits=row_bits,
                               device=p.device)
        key = torch.where(want & (c == kv0), (pri - (1 << 31)) * (1 << 32)
                          + rows, _NO_KEY)
        best = key.min() if n else torch.tensor(_NO_KEY, device=p.device)
        winner = torch.where(best == _NO_KEY, n, best & MASK32)
        has = winner < n
        delta = torch.where(has, p[winner.clamp(max=max(n - 1, 0))], 0) \
            if n else torch.zeros((), dtype=torch.int32, device=p.device)
        kv = _wrap_i32(kv0.to(torch.int64) + delta)
        polled_nw = polled.sum() - (has & poll).to(torch.int64)
        work[3] = winner
    else:
        kv = _wrap_i32(kv0.to(torch.int64)
                       + torch.where(want, p, 0).sum(dtype=torch.int64))
        polled_nw = (polled & ~want).sum()
        work[3] = n                 # no single winner
    inc = 4 * want.sum() + 2 * polled_nw
    return kv, (msgs + inc) & MASK32


def _counter_partial_plain(p: torch.Tensor, c: torch.Tensor,
                           want: torch.Tensor, polled: torch.Tensor,
                           kv0: torch.Tensor, *, cas: bool, wide: bool,
                           row_bits: int, t: int, seed: int,
                           row0: int) -> torch.Tensor:
    """The read pass's partial form over the global rows ``row0 ..``:
    (3,) int64 ``[least key (int64 order, _NO_KEY none), its row's
    pending (cas, 0 for none) or the wanting rows' uint32 sum
    (allreduce), 4 want + 2 polled]``, polled in cas mode every reaching
    row of a poll round."""
    n = p.shape[0]
    dev = p.device
    if cas:
        rows = row0 + torch.arange(n, dtype=torch.int64, device=dev)
        pri = counter_priority(n, t, seed, wide=wide, row_bits=row_bits,
                               device=dev, row0=row0)
        key = torch.where(want & (c == kv0), (pri - (1 << 31)) * (1 << 32)
                          + rows, _NO_KEY)
        best = key.min() if n else torch.tensor(_NO_KEY, device=dev)
        at = ((best & MASK32) - row0).clamp(0, max(n - 1, 0))
        delta = torch.where(best != _NO_KEY, p[at].to(torch.int64), 0) \
            if n else torch.zeros((), dtype=torch.int64, device=dev)
        inc = 4 * want.sum() + 2 * polled.sum()
    else:
        best = torch.tensor(_NO_KEY, device=dev)
        delta = torch.where(want, p, 0).to(torch.int64).sum() & MASK32
        inc = 4 * want.sum() + 2 * (polled & ~want).sum()
    return torch.stack([best, delta, inc.to(torch.int64)])


def counter_apply_plain(pending: torch.Tensor, cached: torch.Tensor,
                        gate: torch.Tensor | None, kv: torch.Tensor,
                        work: torch.Tensor, *, cas: bool, poll: bool,
                        stale_num: int = 0, stale_seed: int = 0,
                        t: int = 0, out=None, row0: int = 0):
    from .kvstore import stale_coin

    n = pending.shape[0]
    p, c, reach = _gated(pending, cached, gate)
    if reach is None:
        reach = torch.ones_like(p, dtype=torch.bool)
    want = (p > 0) & reach
    rows = row0 + torch.arange(n, device=p.device)
    won = rows == work[3] if cas else want
    refreshed = kv.expand(n)
    if stale_num:
        stale = ((stale_coin(stale_seed, t, rows) < stale_num) & ~won
                 & (c != kv))
        refreshed = torch.where(stale, c, refreshed)
    poll_rows = want | won | (reach if poll else False)
    new_p = torch.where(won, 0, p)
    new_c = torch.where(poll_rows, refreshed, c)
    if out is None:
        return new_p, new_c
    out[0].copy_(new_p)
    out[1].copy_(new_c)
    return out


def coin_id(form: int, a: int = 0, j: int = 0) -> tuple[int, int]:
    """One id of a coin descriptor row, ``(form, argument)``: IDENT ``i``;
    SHIFT(``a`` = off in [0, n)) ``(i + off) mod n``; PARENT(``a`` = k)
    ``(i - 1) // k``; CHILD(``a`` = k, ``j``) ``k * i + 1 + j``."""
    return form, a | j << 32


def coin_dir_rows(dirs: torch.Tensor, n: int, *, col0: int = 0,
                  n_ids: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (D, n) int32 sender and receiver id rows of (D, 4) int64
    descriptor rows ``(src form, arg, dst form, arg)`` (:func:`coin_id`),
    in the kernel's uint32 arithmetic (so also at positions where no
    edge exists, where the ids are no node's).  Column i is node ``col0 +
    i`` of a graph of ``n_ids`` nodes (default ``n``: a rank's block of a
    mesh passes its offset and the global count).  Raises on a form or
    argument the kernel does not take."""
    n_ids = n if n_ids is None else n_ids
    i = col0 + torch.arange(n, dtype=torch.int64, device=dirs.device)

    def ids(form: int, arg: int) -> torch.Tensor:
        a, j = arg & MASK32, arg >> 32
        if form == COIN_IDENT and arg == 0:
            v = i
        elif form == COIN_SHIFT and a < n_ids and j == 0:
            v = torch.where(i + a >= n_ids, i + a - n_ids, i + a)
        elif form == COIN_PARENT and a >= 1 and j == 0:
            v = ((i - 1) & MASK32) // a
        elif form == COIN_CHILD and a >= 1 and 0 <= j < MASK32:
            v = (a * i + 1 + j) & MASK32
        else:
            raise ValueError(f"no coin id form ({form}, {arg}) at n = "
                             f"{n_ids}")
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    rows = dirs.tolist()
    return (torch.stack([ids(f, a) for f, a, _, _ in rows]),
            torch.stack([ids(f, a) for _, _, f, a in rows]))


# -- build and load ------------------------------------------------------


def _find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _lib_path(name: str) -> Path:
    """Where source ``name``'s library is built: keyed by a hash of the
    source and the flags."""
    key = hashlib.sha256(SOURCES[name].read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources of :data:`SOURCES` (default: all) into
    shared libraries, those not built yet in parallel, one ``nvcc``
    each.  Returns {name: library path}; each build's compiler output
    sits beside its library as ``.log``.  Raises if ``nvcc`` is missing
    or any build fails."""
    libs = {name: _lib_path(name) for name in (names or SOURCES)}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the flood kernels are built with the CUDA "
            "toolkit on first use of a CUDA tensor")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        lib = todo[name]
        lib.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name} ({proc.returncode}):\n"
                          f"{err[-4000:]}")
        else:
            os.replace(tmp, lib)      # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return libs


def _lib(name: str) -> ctypes.CDLL:
    if name not in _lib_handles:
        lib = ctypes.CDLL(str(build([name])[name]))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        argtypes = {
            "tree_flood": {
                "gg_tree_exchange": [ptr, ptr, i64, i64, i32, ptr],
                "gg_tree_masked_exchange": [ptr, ptr, ptr, ptr, i64, i64,
                                            i32, ptr],
                "gg_tree_ring_exchange": [ptr, ptr, ptr, i64, i64, i64, i32,
                                          ptr, i32, ptr],
                "gg_tree_flood_round": [ptr, ptr, ptr, i64, i64, i32, ptr],
                "gg_col_popcount": [ptr, ptr, i64, i64, ptr],
                "gg_tree_halo_pack": [ptr, ptr, ptr, i64, i64, i32, ptr],
                "gg_tree_halo_round": [ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                       i64, i32, ptr]},
            "shift_flood": {
                "gg_shift_exchange": [ptr, ptr, i64, i64, ptr, i32, ptr],
                "gg_shift_masked_exchange": [ptr, ptr, ptr, i64, i64, ptr,
                                             i32, ptr],
                "gg_shift_flood_round": [ptr, ptr, ptr, i64, i64, ptr, i32,
                                         ptr],
                "gg_shift_ring_exchange": [ptr, ptr, ptr, i64, i64, i64, ptr,
                                           i32, ptr]},
            "gather_flood": {
                "gg_gather_or": [ptr, ptr, ptr, ptr, i64, i64, i64, i32,
                                 ptr],
                "gg_sync_diff_pc": [ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                                    i32, ptr],
                "gg_gather_flood_round": [ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                          i64, i64, i32, ptr],
                "gg_col_popcount_nm": [ptr, ptr, i64, i64, ptr],
                "gg_gather_nodes_per_block": [i64, i32]},
            "fault_flood": {
                "gg_fault_coins": [ptr, ptr, ptr, ptr, ptr, i64, i32, i64,
                                   i64, i64, i64, i64, i64, i64, i32, i32,
                                   i32, ptr],
                "gg_faulted_gather_round": [ptr, ptr, ptr, ptr, ptr, ptr,
                                            ptr, ptr, i64, i64, i64, i32,
                                            ptr],
                "gg_faulted_nodes_per_block": [i64, i32],
                "gg_faulted_gather_round_batched": [ptr, ptr, ptr, ptr, ptr,
                                                    ptr, ptr, ptr, i64, i64,
                                                    i64, i32, i64, ptr],
                "gg_fold_freeze": [ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                                   ptr],
                "gg_wm_fault_coins": [ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                                      i64, i64, i64, i64, i32, i32, i32,
                                      ptr]},
            "counter_round": {
                "gg_counter_select": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                      ptr, i64, i64, i64, i32, i32, i32, i32,
                                      ptr],
                "gg_counter_apply": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                     i64, i32, i32, i64, i64, ptr]},
            "kafka_round": {
                "gg_kafka_merge": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                   ptr, ptr, i64, i64, i64, i32, ptr],
                "gg_kafka_nem_deliver": [ptr, ptr, ptr, ptr, i64, i64, i64,
                                         i64, i64, i64, i64, i64, i64, i32,
                                         i64, i64, ptr],
                "gg_kafka_commit_select": [ptr, ptr, ptr, ptr, ptr, ptr,
                                           ptr, ptr, ptr, ptr, ptr, ptr,
                                           i64, i64, i64, i64, ptr],
                "gg_kafka_commit_apply": [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                          ptr, ptr, ptr, ptr, i64, i64, i64,
                                          i64, i32, i64, i64, ptr]},
            "traffic_fold": {
                "gg_and_fold_rows": [ptr, ptr, i64, i64, ptr],
                "gg_and_fold_cols": [ptr, ptr, i64, i64, ptr]},
            "prov_flood": {
                "gg_prov_attribute": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                      i64, i64, i64, i32, i64, i32, i32,
                                      ptr]},
            "txn_round": {
                "gg_txn_claim": [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                                 i64, i64, i64, i64, ptr],
                "gg_txn_commit": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                  i64, i64, i64, i64, i64, i64, i64, ptr]},
        }[name]
        for fn_name, types in argtypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _lib_handles[name] = lib
    return _lib_handles[name]


# -- wrappers ------------------------------------------------------------


def _check_bitset(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D ((W, N) or (N, W)), got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True for CPU tensors (the plain path); False for CUDA tensors on
    one device; raises for anything else."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("tensors lie on different devices: "
                         f"{[str(x.device) for x in xs]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no flood kernel for device {dev}")
    return False


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check_words(w: int) -> None:
    if w > MAX_WORDS:
        raise ValueError(f"W = {w} words exceeds the kernels' {MAX_WORDS}")


def _check_branching(branching: int) -> None:
    if branching < 1:
        raise ValueError(f"branching must be >= 1, got {branching}")


def _check_flood_buffers(received: torch.Tensor, frontier: torch.Tensor,
                         frontier_next: torch.Tensor) -> bool:
    """Validate a fused round's three buffers; returns :func:`_on_cpu`."""
    for name, x in (("received", received), ("frontier", frontier),
                    ("frontier_next", frontier_next)):
        _check_bitset(name, x)
    if not (received.shape == frontier.shape == frontier_next.shape):
        raise ValueError(
            f"shape mismatch: received {tuple(received.shape)}, frontier "
            f"{tuple(frontier.shape)}, frontier_next "
            f"{tuple(frontier_next.shape)}")
    on_cpu = _on_cpu(received, frontier, frontier_next)
    if _overlap(frontier_next, frontier):
        raise ValueError("frontier_next aliases frontier: the round reads "
                         "neighbours' frontier words, so it needs a second "
                         "buffer")
    if _overlap(received, frontier) or _overlap(received, frontier_next):
        raise ValueError("received must not alias either frontier buffer")
    return on_cpu


def tree_exchange(payload: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """inbox[:, i] = payload[:, (i-1)//k] (0 at the root) | OR of
    payload[:, k*i+1 .. k*i+k] over the children below N.  On the card,
    k = 4 with N % 4 == 0 and 16-byte aligned rows takes four nodes a
    thread."""
    _check_bitset("payload", payload)
    if _on_cpu(payload):
        return tree_exchange_plain(payload, branching)
    w, n = payload.shape
    _check_words(w)
    _check_branching(branching)
    inbox = torch.empty_like(payload)
    if payload.numel():
        _launch("tree_exchange", _lib("tree_flood").gg_tree_exchange,
                payload.device, payload.data_ptr(), inbox.data_ptr(), w, n,
                branching)
    return inbox


def _check_packed(name: str, rows: torch.Tensor, shape: tuple) -> None:
    if rows.dtype != torch.int32 or tuple(rows.shape) != shape \
            or not rows.is_contiguous():
        raise ValueError(f"{name} must be contiguous packed int32 rows "
                         f"shaped {shape}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")


def tree_masked_exchange(payload: torch.Tensor, live_parent: torch.Tensor,
                         live_kids: torch.Tensor,
                         branching: int = 4) -> torch.Tensor:
    """:func:`tree_exchange` under per-edge liveness: ``inbox[:, i] =
    (P_i ? payload[:, (i-1)//k] : 0) | OR over children c of i (K_c ?
    payload[:, c] : 0)``, where P (``live_parent``, at receiver
    positions) and K (``live_kids``, at child positions: masked before
    the k:1 fold) are (ceil(N/32),) packed rows (:func:`pack_bits`)."""
    _check_bitset("payload", payload)
    w, n = payload.shape
    for name, rows in (("live_parent", live_parent),
                       ("live_kids", live_kids)):
        _check_packed(name, rows, (packed_words(n),))
    if _on_cpu(payload, live_parent, live_kids):
        return tree_masked_exchange_plain(payload, live_parent, live_kids,
                                          branching)
    _check_words(w)
    _check_branching(branching)
    inbox = torch.empty_like(payload)
    if payload.numel():
        _launch("tree_masked_exchange",
                _lib("tree_flood").gg_tree_masked_exchange, payload.device,
                payload.data_ptr(), live_parent.data_ptr(),
                live_kids.data_ptr(), inbox.data_ptr(), w, n, branching)
    return inbox


def _check_ring(ring: torch.Tensor) -> tuple[int, int, int]:
    """(L, W, N) of a payload history ring: a contiguous (L, W, N) int32
    tensor, words-major slots."""
    if ring.dtype != torch.int32 or ring.dim() != 3 \
            or not ring.is_contiguous():
        raise ValueError("ring must be a contiguous (L, W, N) torch.int32 "
                         f"tensor, got {ring.dtype} {tuple(ring.shape)}")
    return tuple(ring.shape)


def _ring_live(live: torch.Tensor | None, rows: int, n: int) -> list:
    """The tensors a ring call's device check covers: ``live`` (checked
    as (rows, ceil(n/32)) packed rows) when given."""
    if live is None:
        return []
    _check_packed("live", live, (rows, packed_words(n)))
    return [live]


def tree_ring_exchange(ring: torch.Tensor, table, live=None,
                       branching: int = 4) -> torch.Tensor:
    """The tree inbox of a payload history ring: the OR over ``table``'s
    ``(slot, kind, row)`` entries of the from-parent term
    (:data:`TREE_PARENT`) of ring slot ``slot``, gated at receivers by
    packed row ``row`` of ``live``, or the from-kids term
    (:data:`TREE_KIDS`) of that slot gated at child positions before the
    k:1 fold (``row`` -1: ungated).  ``ring`` is (L, W, N), ``live``
    (R, ceil(N/32)) packed rows or None.  On the card, k = 4 with N % 4
    == 0 and a 16-byte aligned ring takes four nodes a thread.  An empty
    table gives zeros and launches nothing; one longer than
    :data:`MAX_RING_ENTRIES` runs in launches of that many, ORed."""
    slots, w, n = _check_ring(ring)
    table = tuple((int(a), int(b), int(c)) for a, b, c in table)
    rows = 0 if live is None else live.shape[0]
    for slot, kind, row in table:
        if not (0 <= slot < slots and kind in (TREE_PARENT, TREE_KIDS)
                and -1 <= row < rows):
            raise ValueError(f"ring table entry {(slot, kind, row)}: a slot "
                             f"of {slots}, kind 0 or 1, a row of {rows} or -1")
    if _on_cpu(ring, *_ring_live(live, rows, n)):
        return tree_ring_exchange_plain(ring, table, live, branching)
    _check_words(w)
    _check_branching(branching)
    inbox = None
    for at in range(0, len(table), MAX_RING_ENTRIES):
        part = table[at:at + MAX_RING_ENTRIES]
        words = [x for entry in part for x in entry]
        out = torch.empty((w, n), dtype=torch.int32, device=ring.device)
        if out.numel():
            _launch("tree_ring_exchange",
                    _lib("tree_flood").gg_tree_ring_exchange, ring.device,
                    ring.data_ptr(), None if live is None else live.data_ptr(),
                    out.data_ptr(), slots, w, n, branching,
                    (ctypes.c_int64 * len(words))(*words), len(part))
        inbox = out if inbox is None else inbox | out
    if inbox is None:
        return torch.zeros((w, n), dtype=torch.int32, device=ring.device)
    return inbox


def tree_flood_round(received: torch.Tensor, frontier: torch.Tensor,
                     frontier_next: torch.Tensor,
                     branching: int = 4) -> torch.Tensor:
    """One pure-flood round: ``new = tree_exchange(frontier) & ~received``,
    then ``received |= new`` IN PLACE and ``frontier_next[:] = new``.
    ``frontier_next`` must be a distinct buffer (column i reads its
    neighbours' frontier words).  Returns ``frontier_next``."""
    if _check_flood_buffers(received, frontier, frontier_next):
        return tree_flood_round_plain(received, frontier, frontier_next,
                                      branching)
    w, n = received.shape
    _check_words(w)
    _check_branching(branching)
    if received.numel():
        _launch("tree_flood_round", _lib("tree_flood").gg_tree_flood_round,
                received.device, received.data_ptr(), frontier.data_ptr(),
                frontier_next.data_ptr(), w, n, branching)
    return frontier_next


def _check_halo_block(w: int, b: int, branching: int) -> int:
    """B/k of a halo block: k must divide B (the reference's gate)."""
    _check_branching(branching)
    if b < branching or b % branching:
        raise ValueError(f"a tree halo block needs k | B and B >= k: B = "
                         f"{b}, k = {branching}")
    return b // branching


def tree_halo_pack(payload: torch.Tensor, branching: int = 4,
                   live: torch.Tensor | None = None) -> torch.Tensor:
    """The child partial a (W, B) block sends its parent shard
    (:func:`tree_halo_pack_plain`): a contiguous (W, B/k + 1) buffer.
    ``live``: a (ceil(B/32),) packed row masking the block's columns
    before the fold."""
    _check_bitset("payload", payload)
    w, b = payload.shape
    sub = _check_halo_block(w, b, branching)
    rows = []
    if live is not None:
        _check_packed("live", live, (packed_words(b),))
        rows = [live]
    if _on_cpu(payload, *rows):
        return tree_halo_pack_plain(payload, branching, live)
    _check_words(w)
    out = torch.empty((w, sub + 1), dtype=torch.int32,
                      device=payload.device)
    if out.numel():
        _launch("tree_halo_pack", _lib("tree_flood").gg_tree_halo_pack,
                payload.device, payload.data_ptr(),
                None if live is None else live.data_ptr(), out.data_ptr(),
                w, b, branching)
    return out


def tree_halo_round(buf: torch.Tensor, ek: torch.Tensor,
                    back: torch.Tensor | None, branching: int = 4,
                    live: torch.Tensor | None = None, *,
                    received: torch.Tensor | None = None,
                    frontier_next: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """The halo tree inbox of a (W, B) block from the received parent
    slice ``buf`` (W, B/k + 1), the kids' landing buffer ``ek`` (W, B +
    1) and the back-folded column ``back`` (W,) or None
    (:func:`tree_halo_round_plain`); ``live`` a (ceil(B/32),) packed row
    gating the parent term.  Returns the inbox; or, given ``received``
    and ``frontier_next`` ((W, B) each, distinct buffers), runs the
    fused flood round in place and returns ``frontier_next``."""
    for name, x in (("buf", buf), ("ek", ek)):
        _check_bitset(name, x)
    w, b = ek.shape[0], ek.shape[1] - 1
    sub = _check_halo_block(w, b, branching)
    if tuple(buf.shape) != (w, sub + 1):
        raise ValueError(f"buf must be (W, B/k + 1) = {(w, sub + 1)}, got "
                         f"{tuple(buf.shape)}")
    extra = []
    if back is not None:
        if back.dtype != torch.int32 or back.numel() != w:
            raise ValueError(f"back must hold W = {w} int32 words, got "
                             f"{back.dtype} {tuple(back.shape)}")
        back = back.reshape(w).contiguous()
        extra.append(back)
    if live is not None:
        _check_packed("live", live, (packed_words(b),))
        extra.append(live)
    if (received is None) != (frontier_next is None):
        raise ValueError("the fused round takes received and "
                         "frontier_next together")
    if received is not None:
        for name, x in (("received", received),
                        ("frontier_next", frontier_next)):
            _check_bitset(name, x)
            if tuple(x.shape) != (w, b):
                raise ValueError(f"{name} must be (W, B) = {(w, b)}")
        if _overlap(received, frontier_next):
            raise ValueError("received must not alias frontier_next")
        extra += [received, frontier_next]
    if _on_cpu(buf, ek, *extra):
        return tree_halo_round_plain(buf, ek, back, branching, live,
                                     received, frontier_next)
    _check_words(w)
    out = (torch.empty((w, b), dtype=torch.int32, device=buf.device)
           if received is None else frontier_next)
    if out.numel():
        _launch("tree_halo_round", _lib("tree_flood").gg_tree_halo_round,
                buf.device, buf.data_ptr(), ek.data_ptr(),
                None if back is None else back.data_ptr(),
                None if live is None else live.data_ptr(), out.data_ptr(),
                None if received is None else received.data_ptr(), w, b,
                branching)
    return out


def col_popcount(x: torch.Tensor, node_major: bool = False) -> torch.Tensor:
    """(N,) int32 per-node popcount sum over the W words of a (W, N)
    words-major bitset, or of an (N, W) one with ``node_major``."""
    _check_bitset("x", x)
    if _on_cpu(x):
        return col_popcount_plain(x, node_major)
    n, w = x.shape if node_major else x.shape[::-1]
    if not x.numel():
        return torch.zeros(n, dtype=torch.int32, device=x.device)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if node_major:
        _launch("col_popcount_nm", _lib("gather_flood").gg_col_popcount_nm,
                x.device, x.data_ptr(), out.data_ptr(), n, w)
    else:
        _launch("col_popcount", _lib("tree_flood").gg_col_popcount,
                x.device, x.data_ptr(), out.data_ptr(), w, n)
    return out


def _one_source(dirs: ShiftDirs) -> None:
    if dirs.slots:
        raise ValueError("a ring table (ShiftDirs.slots) goes to "
                         "shift_ring_exchange")


def shift_exchange(payload: torch.Tensor, dirs: ShiftDirs) -> torch.Tensor:
    """inbox[:, i] = OR over the directions of ``dirs`` (see
    :class:`ShiftDirs`) of the shifted payload."""
    _check_bitset("payload", payload)
    if _on_cpu(payload):
        return shift_exchange_plain(payload, dirs)
    w, n = payload.shape
    _check_words(w)
    _one_source(dirs)
    plan = _shift_plan(dirs, n, False)
    inbox = torch.empty_like(payload)
    if payload.numel():
        _launch("shift_exchange", _lib("shift_flood").gg_shift_exchange,
                payload.device, payload.data_ptr(), inbox.data_ptr(), w, n,
                *plan)
    return inbox


def shift_masked_exchange(payload: torch.Tensor, live: torch.Tensor,
                          dirs: ShiftDirs,
                          max_tile: int = SHIFT_TILE) -> torch.Tensor:
    """:func:`shift_exchange` under per-direction liveness: direction d's
    term counts at receiver i only where i's bit of packed row d of
    ``live`` ((len(dirs.offs), ceil(N/32)) int32, :func:`pack_bits`) is
    set; the table's column masks still apply.  ``max_tile`` caps the
    kernel's tile (:func:`_shift_plan`): a smaller one, or one that is no
    multiple of 32 nodes, gives the same result."""
    _check_bitset("payload", payload)
    w, n = payload.shape
    _check_packed("live", live, (len(dirs.offs), packed_words(n)))
    if _on_cpu(payload, live):
        return shift_masked_exchange_plain(payload, live, dirs)
    _check_words(w)
    if max_tile < 1:
        raise ValueError(f"max_tile must be >= 1, got {max_tile}")
    _one_source(dirs)
    plan = _shift_plan(dirs, n, False, max_tile, live=True)
    inbox = torch.empty_like(payload)
    if payload.numel():
        _launch("shift_masked_exchange",
                _lib("shift_flood").gg_shift_masked_exchange, payload.device,
                payload.data_ptr(), live.data_ptr(), inbox.data_ptr(), w, n,
                *plan)
    return inbox


def shift_ring_exchange(ring: torch.Tensor, dirs: ShiftDirs, live=None,
                        max_tile: int = SHIFT_TILE) -> torch.Tensor:
    """The shift inbox of a payload history ring: the OR over the rows d
    of the ring table ``dirs`` (its ``slots`` set) of direction d's term
    of ring slot ``dirs.slots[d]``, gated at receivers by packed row d of
    ``live`` when given ((len(dirs.offs), ceil(N/32)) int32), under the
    table's column masks.  ``ring`` is (L, W, N).  One launch stages
    each tile's rows a group (:func:`shift_groups`: a slot's rows) at a
    time and stores the inbox once.  An empty table gives zeros and
    launches nothing; one of more than :data:`MAX_RING_ROWS` rows runs in
    launches of that many, ORed.  ``max_tile`` as in
    :func:`shift_masked_exchange`."""
    slots, w, n = _check_ring(ring)
    if len(dirs.slots) != len(dirs.offs) or any(
            not 0 <= s < slots for s in dirs.slots):
        raise ValueError(f"a ring table names a slot of the {slots}-slot "
                         "ring for each of its rows")
    if _on_cpu(ring, *_ring_live(live, len(dirs.offs), n)):
        return shift_ring_exchange_plain(ring, dirs, live)
    _check_words(w)
    if max_tile < 1:
        raise ValueError(f"max_tile must be >= 1, got {max_tile}")
    inbox = None
    for at in range(0, len(dirs.offs), MAX_RING_ROWS):
        part = slice(at, at + MAX_RING_ROWS)
        sub = ShiftDirs(dirs.offs[part], dirs.flags[part], dirs.cols,
                        dirs.slots[part])
        plan = _shift_plan(sub, n, False, max_tile, live is not None)
        out = torch.empty((w, n), dtype=torch.int32, device=ring.device)
        if out.numel():
            _launch("shift_ring_exchange",
                    _lib("shift_flood").gg_shift_ring_exchange, ring.device,
                    ring.data_ptr(),
                    None if live is None else live[part].data_ptr(),
                    out.data_ptr(), slots, w, n, *plan)
        inbox = out if inbox is None else inbox | out
    if inbox is None:
        return torch.zeros((w, n), dtype=torch.int32, device=ring.device)
    return inbox


def shift_flood_round(received: torch.Tensor, frontier: torch.Tensor,
                      frontier_next: torch.Tensor,
                      dirs: ShiftDirs) -> torch.Tensor:
    """One pure-flood round over a shift topology: ``new =
    shift_exchange(frontier, dirs) & ~received``, then ``received |=
    new`` IN PLACE and ``frontier_next[:] = new`` (a distinct buffer).
    Returns ``frontier_next``."""
    if _check_flood_buffers(received, frontier, frontier_next):
        return shift_flood_round_plain(received, frontier, frontier_next,
                                       dirs)
    w, n = received.shape
    _check_words(w)
    _one_source(dirs)
    plan = _shift_plan(dirs, n, True)
    if received.numel():
        _launch("shift_flood_round",
                _lib("shift_flood").gg_shift_flood_round, received.device,
                received.data_ptr(), frontier.data_ptr(),
                frontier_next.data_ptr(), w, n, *plan)
    return frontier_next


def _check_gather(payload: torch.Tensor, nbrs: torch.Tensor,
                  live: torch.Tensor | None,
                  recv: torch.Tensor | None = None) -> bool:
    """Validate a gather's operands; returns :func:`_on_cpu`."""
    _check_bitset("payload", payload)
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2 \
            or not nbrs.is_contiguous():
        raise ValueError("nbrs must be a contiguous (N, D) torch.int32 "
                         f"table, got {nbrs.dtype} {tuple(nbrs.shape)}")
    if payload.shape[0] < 1 or nbrs.shape[1] < 1:
        raise ValueError("the gather needs at least one payload row and "
                         "one degree column")
    if max(payload.shape[0], nbrs.shape[0]) > MAX_NODES:
        raise ValueError(f"the gather takes at most {MAX_NODES} nodes")
    if live is not None and (live.dtype != torch.bool
                             or live.shape != nbrs.shape
                             or not live.is_contiguous()):
        raise ValueError("live must be a contiguous bool tensor shaped "
                         "like nbrs")
    if recv is not None:
        _check_bitset("recv", recv)
        if recv.shape != (nbrs.shape[0], payload.shape[1]):
            raise ValueError(f"recv {tuple(recv.shape)} must be (N, W) = "
                             f"({nbrs.shape[0]}, {payload.shape[1]})")
    xs = [payload, nbrs] + [x for x in (live, recv) if x is not None]
    return _on_cpu(*xs)


def gather_nodes_per_block(w: int) -> int:
    """Nodes one block of the gather kernels serves at W words a node on
    16-byte aligned rows: a lane per 16-byte vector (W % 4 == 0) or per
    word, up to a warp per node row.  The kernels' launch geometry, which
    ``gg_gather_nodes_per_block`` reports from the library itself."""
    units = w // 4 if w % 4 == 0 else w
    return GATHER_THREADS // min(32, 1 << (units - 1).bit_length())


def gather_or(payload: torch.Tensor, nbrs: torch.Tensor,
              live: torch.Tensor | None = None) -> torch.Tensor:
    """Node-major inbox: ``inbox[i] = OR_d (live[i, d] ?
    payload[nbrs[i, d]] : 0)``, out of place; ``live=None`` delivers
    exactly the edges with ``nbrs >= 0``.  Indices are clipped into
    the payload's rows before the mask applies, as the reference's."""
    if _check_gather(payload, nbrs, live):
        return gather_or_plain(payload, nbrs, live)
    n, d = nbrs.shape
    w = payload.shape[1]
    inbox = torch.empty(n, w, dtype=torch.int32, device=payload.device)
    if inbox.numel():
        _launch("gather_or", _lib("gather_flood").gg_gather_or,
                payload.device, payload.data_ptr(), nbrs.data_ptr(),
                None if live is None else live.data_ptr(),
                inbox.data_ptr(), n, w, payload.shape[0], d)
    return inbox


def gather_flood_round(payload: torch.Tensor, rec: torch.Tensor,
                       nbrs: torch.Tensor,
                       live: torch.Tensor | None = None):
    """One node-major gather round, fused: ``new = gather_or(payload,
    nbrs, live) & ~rec`` and ``rec_next = rec | new``, both new tensors
    (out of place: on sync rounds ``payload`` is ``rec``).  Returns
    ``(new, rec_next)``."""
    if _check_gather(payload, nbrs, live, rec):
        return gather_flood_round_plain(payload, rec, nbrs, live)
    n, d = nbrs.shape
    w = payload.shape[1]
    new, rec_next = torch.empty_like(rec), torch.empty_like(rec)
    if new.numel():
        _launch("gather_flood_round",
                _lib("gather_flood").gg_gather_flood_round, payload.device,
                payload.data_ptr(), rec.data_ptr(), nbrs.data_ptr(),
                None if live is None else live.data_ptr(), new.data_ptr(),
                rec_next.data_ptr(), n, w, payload.shape[0], d)
    return new, rec_next


def sync_diff_pc(payload: torch.Tensor, recv: torch.Tensor,
                 nbrs: torch.Tensor,
                 live: torch.Tensor | None = None) -> torch.Tensor:
    """() int64 holding a uint32: the sum over delivering edges (i, d) of
    ``popc(payload[nbrs[i, d]] & ~recv[i])`` mod 2^32 — one sync wave's
    targeted-push volume."""
    if _check_gather(payload, nbrs, live, recv):
        return sync_diff_pc_plain(payload, recv, nbrs, live)
    n, d = nbrs.shape
    w = payload.shape[1]
    # the kernel adds uint32 words into the low half of a zeroed int64
    # (little-endian), which then holds the sum mod 2^32 as it is
    out = torch.zeros((), dtype=torch.int64, device=payload.device)
    if recv.numel():
        _launch("sync_diff_pc", _lib("gather_flood").gg_sync_diff_pc,
                payload.device, payload.data_ptr(), recv.data_ptr(),
                nbrs.data_ptr(), None if live is None else live.data_ptr(),
                out.data_ptr(), n, w, payload.shape[0], d)
    return out


def _check_table(nbrs: torch.Tensor, mask: torch.Tensor | None, name: str,
                 dtype: torch.dtype) -> None:
    """Validate an (n, D) neighbor table and a per-edge ``mask`` of
    ``dtype`` shaped like it (or None)."""
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2 \
            or not nbrs.is_contiguous() or nbrs.shape[1] < 1:
        raise ValueError("nbrs must be a contiguous (n, D) torch.int32 "
                         f"table, D >= 1, got {nbrs.dtype} "
                         f"{tuple(nbrs.shape)}")
    if mask is not None and (mask.dtype != dtype
                             or mask.shape != nbrs.shape
                             or not mask.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                         "shaped like nbrs")


def fault_coins(nbrs: torch.Tensor, up: torch.Tensor, *, t: int,
                seed: int = 0, loss_num: int = 0, dup_num: int = 0,
                loss: bool = False, dup: bool = False, out_ok: bool = False,
                live: torch.Tensor | None = None, row0: int = 0,
                table: torch.Tensor | None = None,
                block: int = 0) -> torch.Tensor:
    """The round's per-edge coins as one (n, D) uint8 flag byte an edge of
    the slab ``nbrs`` (node rows ``row0 ..``): :data:`FLAG_SEND` (live —
    ``live``, else ``nbrs >= 0`` — and both endpoints ``up``),
    :data:`FLAG_DEL` (sent and not dropped by the loss coin of src ->
    dst), :data:`FLAG_DUP` (delivered and the dup coin fired) and, with
    ``out_ok``, :data:`FLAG_OUT_OK` (the loss coin of dst -> src did not
    drop).  ``loss`` / ``dup``: whether each stream is active this round
    (``t`` below its horizon); the coins are the reference's
    ``edge_drop`` / ``edge_dup`` hashes of ``(seed, t, src, dst)`` over
    the source index clipped into ``up``'s rows.

    The scenario batch's form (``table``, an (S, 5) int64 tensor, and
    ``block`` = N): S scenarios folded into one graph of S N rows, node
    row r of scenario ``r // N``, whose row of the table gives its
    ``seed``, ``loss_num``, ``dup_num`` and whether ``loss`` and ``dup``
    are active (1 / 0); the scalar arguments are then unused but ``t``
    and ``out_ok``.  Each scenario's coins hash its own ids (``dst - s
    N``, ``src - s N``), a source index clipped into its own rows (a -1
    pad to its row 0), so each scenario's flags are those of its
    one-scenario call."""
    _check_table(nbrs, live, "live", torch.bool)
    if up.dtype != torch.bool or up.dim() != 1 or not up.is_contiguous():
        raise ValueError("up must be a contiguous (N,) bool tensor")
    n, d = nbrs.shape
    if not 0 <= row0 <= up.shape[0] - n:
        raise ValueError(f"rows [{row0}, {row0 + n}) are not node ids of "
                         f"the {up.shape[0]}-row up vector")
    if table is not None:
        if block < 1 or up.shape[0] % block \
                or table.shape != (up.shape[0] // block, 5) \
                or table.dtype != torch.int64 or not table.is_contiguous():
            raise ValueError(
                f"a batched coin call needs block >= 1 dividing the "
                f"{up.shape[0]} rows and a contiguous (S, 5) int64 table; "
                f"got block {block}, table {table.dtype} "
                f"{tuple(table.shape)}")
    args = dict(t=t, seed=seed, loss_num=loss_num, dup_num=dup_num,
                loss=loss, dup=dup, out_ok=out_ok, live=live, row0=row0,
                table=table, block=block)
    if _on_cpu(*[x for x in (nbrs, up, live, table) if x is not None]):
        return fault_coins_plain(nbrs, up, **args)
    flags = torch.empty(n, d, dtype=torch.uint8, device=nbrs.device)
    if n:
        _launch("fault_coins" if table is None else "fault_coins_batched",
                _lib("fault_flood").gg_fault_coins, nbrs.device,
                nbrs.data_ptr(), None if live is None else live.data_ptr(),
                up.data_ptr(), None if table is None else table.data_ptr(),
                flags.data_ptr(), n, d, up.shape[0], row0, block,
                t & MASK32, seed & MASK32, loss_num & MASK32,
                dup_num & MASK32, int(loss), int(dup), int(out_ok))
    return flags


def faulted_gather_round(payload: torch.Tensor,
                         received: torch.Tensor | None, rec: torch.Tensor,
                         nbrs: torch.Tensor, flags: torch.Tensor,
                         block: int = 0):
    """One faulted gather round over the slab ``nbrs`` / ``rec`` / ``flags``
    (n rows): ``inbox[i] = OR_d (DEL ? payload[nbrs[i, d]] : 0) | (DUP ?
    received[nbrs[i, d]] : 0)``, ``new = inbox & ~rec``, ``rec_next = rec
    | new`` (new tensors: on sync rounds ``payload`` is ``received``), and
    the dup charge ``sum over DUP edges of popc(received[nbrs[i, d]])``
    mod 2^32 as a () int64.  ``received=None``: no dup stream (the DUP
    bits are not read).  Indices are clipped into the payload's rows.
    Returns ``(new, rec_next, dup_pc)``.  ``block`` (the scenario batch,
    S scenarios of ``block`` rows folded): ``dup_pc`` is (S,), each
    scenario's own charge mod 2^32."""
    _check_bitset("payload", payload)
    _check_bitset("rec", rec)
    _check_table(nbrs, flags, "flags", torch.uint8)
    if received is not None:
        _check_bitset("received", received)
        if received.shape != payload.shape:
            raise ValueError(f"received {tuple(received.shape)} must be "
                             f"shaped like payload {tuple(payload.shape)}")
    if payload.shape[0] < 1 or payload.shape[0] > MAX_NODES \
            or rec.shape[0] > MAX_NODES:
        raise ValueError(f"the gather takes 1 to {MAX_NODES} nodes")
    if rec.shape != (nbrs.shape[0], payload.shape[1]):
        raise ValueError(f"rec {tuple(rec.shape)} must be (n, W) = "
                         f"({nbrs.shape[0]}, {payload.shape[1]})")
    if block and (block < 1 or nbrs.shape[0] % block):
        raise ValueError(f"block {block} does not divide the "
                         f"{nbrs.shape[0]} rows")
    xs = [payload, rec, nbrs, flags] + ([] if received is None
                                        else [received])
    if _on_cpu(*xs):
        return faulted_gather_round_plain(payload, received, rec, nbrs,
                                          flags, block)
    n, d = nbrs.shape
    w = payload.shape[1]
    new, rec_next = torch.empty_like(rec), torch.empty_like(rec)
    # the kernel adds uint32 words into the low half of a zeroed int64
    dup_pc = torch.zeros((n // block,) if block else (), dtype=torch.int64,
                         device=payload.device)
    if new.numel():
        if block:
            _launch("faulted_gather_round_batched",
                    _lib("fault_flood").gg_faulted_gather_round_batched,
                    payload.device, payload.data_ptr(),
                    None if received is None else received.data_ptr(),
                    rec.data_ptr(), nbrs.data_ptr(), flags.data_ptr(),
                    new.data_ptr(), rec_next.data_ptr(), dup_pc.data_ptr(),
                    n, w, payload.shape[0], d, block)
        else:
            _launch("faulted_gather_round",
                    _lib("fault_flood").gg_faulted_gather_round,
                    payload.device, payload.data_ptr(),
                    None if received is None else received.data_ptr(),
                    rec.data_ptr(), nbrs.data_ptr(), flags.data_ptr(),
                    new.data_ptr(), rec_next.data_ptr(), dup_pc.data_ptr(),
                    n, w, payload.shape[0], d)
    return new, rec_next, dup_pc


def fold_freeze(dst: torch.Tensor, src: torch.Tensor, active: torch.Tensor,
                block: int, dst1: torch.Tensor | None = None,
                src1: torch.Tensor | None = None) -> None:
    """The scenario batch's freeze, in place: the rows ``[s block, (s + 1)
    block)`` of ``dst`` (and ``dst1``) take ``src``'s (``src1``'s) where
    ``active[s]``; a frozen scenario's rows stay.  ``dst`` / ``src``:
    (rows, W) int32, ``active`` (rows / block,) bool."""
    pairs = [(dst, src)] + ([] if dst1 is None else [(dst1, src1)])
    for d, s_ in pairs:
        _check_bitset("dst", d)
        _check_bitset("src", s_)
        if d.shape != dst.shape or s_.shape != dst.shape:
            raise ValueError(f"freeze pairs must share one shape, got "
                             f"{tuple(d.shape)} and {tuple(s_.shape)}")
        if _overlap(d, s_):
            raise ValueError("a freeze destination aliases its source")
    if active.dtype != torch.bool or active.dim() != 1 \
            or not active.is_contiguous() or block < 1 \
            or active.shape[0] * block != dst.shape[0]:
        raise ValueError(f"active must be a contiguous (rows / block,) "
                         f"bool tensor; got {active.dtype} "
                         f"{tuple(active.shape)} for {dst.shape[0]} rows, "
                         f"block {block}")
    if _on_cpu(dst, src, active, *([] if dst1 is None else [dst1, src1])):
        return fold_freeze_plain(dst, src, active, block, dst1, src1)
    if dst.numel():
        _launch("fold_freeze", _lib("fault_flood").gg_fold_freeze,
                dst.device, dst.data_ptr(), src.data_ptr(),
                None if dst1 is None else dst1.data_ptr(),
                None if src1 is None else src1.data_ptr(),
                active.data_ptr(), dst.shape[0], dst.shape[1], block)


def wm_fault_coins(dirs: torch.Tensor, n: int, live: torch.Tensor, *,
                   t: int, seed: int, loss_num: int, dup_num: int,
                   loss: bool, dup: bool, srv: bool, col0: int = 0,
                   n_ids: int | None = None):
    """The words-major nemesis's coins over direction rows: ``dirs`` the
    (D, 4) int64 descriptors of each row's sender and receiver ids
    (:func:`coin_id`, built by structured.coin_dirs), ``live`` the (D,
    ceil(n/32)) packed send liveness.  Precondition: the live bits lie
    inside the rows' ``exists`` positions, the only ones where the
    descriptors give the edge's ids.  Returns two packed row sets
    ``(out0, out1)``:

    - delivery (``srv=False``): ``out0`` = live and the loss coin of src
      -> dst did not drop (``loss``: the stream is active); ``out1`` =
      out0 and the dup coin of src -> dst fired, or None without
      ``dup``;
    - ledger (``srv=True``): ``out0`` = live and the loss coin of dst ->
      src (the reply) did not drop; ``out1`` = out0 and the coin of src
      -> dst did not either.

    The coins are the reference's ``edge_drop`` / ``edge_dup`` hashes of
    ``(seed, t, src, dst)``; the plain version takes the id rows of
    :func:`coin_dir_rows`.  On the card the kernel computes the ids in
    registers.  ``n`` is the rows' column count; on a rank's block of a
    mesh column i is node ``col0 + i`` of ``n_ids`` (default ``n``), and
    the ids, hence the coins, are the global ones."""
    n_ids = n if n_ids is None else n_ids
    if col0 < 0 or col0 + n > n_ids:
        raise ValueError(f"columns {col0} .. {col0 + n} lie outside the "
                         f"{n_ids} nodes")
    if dirs.dtype != torch.int64 or dirs.dim() != 2 or dirs.shape[1] != 4 \
            or not dirs.is_contiguous():
        raise ValueError(f"dirs must be contiguous (D, 4) int64 descriptor "
                         f"rows, got {dirs.dtype} {tuple(dirs.shape)}")
    d = dirs.shape[0]
    _check_packed("live", live, (d, packed_words(n)))
    args = dict(t=t, seed=seed, loss_num=loss_num, dup_num=dup_num,
                loss=loss, dup=dup, srv=srv)
    if _on_cpu(dirs, live):
        return wm_fault_coins_plain(
            *coin_dir_rows(dirs, n, col0=col0, n_ids=n_ids), live, **args)
    if d > MAX_WORDS:
        raise ValueError(f"{d} direction rows exceed the kernel's "
                         f"{MAX_WORDS}")
    if not 1 <= n <= n_ids <= MAX_NODES:
        raise ValueError(f"n = {n} columns of {n_ids} nodes: the kernel "
                         f"takes 1 .. {MAX_NODES}")
    out0 = torch.empty_like(live)
    out1 = torch.empty_like(live) if srv or dup else None
    if live.numel():
        _launch("wm_fault_coins", _lib("fault_flood").gg_wm_fault_coins,
                live.device, dirs.data_ptr(), live.data_ptr(),
                out0.data_ptr(), None if out1 is None else out1.data_ptr(),
                d, n, col0, n_ids, t & MASK32, seed & MASK32,
                loss_num & MASK32,
                dup_num & MASK32, int(loss), int(dup), int(srv))
    return out0, out1


def counter_work(device) -> torch.Tensor:
    """A counter round's work words (:data:`COUNTER_WORK_WORDS` int64) in
    their resting state: the winner key all ones, the counters 0.
    :func:`counter_select` finalizes the round into word 3 and leaves the
    rest so again."""
    work = torch.zeros(COUNTER_WORK_WORDS, dtype=torch.int64, device=device)
    work[0] = -1
    return work


def _check_counter(pending: torch.Tensor, cached: torch.Tensor,
                   gate: torch.Tensor | None, work: torch.Tensor,
                   scalars: dict) -> bool:
    """Validate a counter round's operands; returns :func:`_on_cpu`."""
    n = pending.shape[0]
    for name, x in (("pending", pending), ("cached", cached)):
        if x.dtype != torch.int32 or x.shape != (n,) \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (N,) int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if gate is not None and (gate.dtype != torch.uint8
                             or gate.shape != (n,)
                             or not gate.is_contiguous()):
        raise ValueError("gate must be a contiguous (N,) uint8 tensor")
    if work.dtype != torch.int64 or work.shape != (COUNTER_WORK_WORDS,) \
            or not work.is_contiguous():
        raise ValueError(f"work must be ({COUNTER_WORK_WORDS},) int64 "
                         "(counter_work)")
    for name, (x, dtype) in scalars.items():
        if x.dtype != dtype or x.dim() != 0:
            raise ValueError(f"{name} must be a 0-dim {dtype} tensor")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the counter round takes < 2^31")
    xs = [pending, cached, work] + [x for x, _ in scalars.values()]
    return _on_cpu(*xs, *([] if gate is None else [gate]))


def counter_select(pending: torch.Tensor, cached: torch.Tensor,
                   gate: torch.Tensor | None, kv0: torch.Tensor,
                   msgs: torch.Tensor, work: torch.Tensor, *, cas: bool,
                   wide: bool, row_bits: int, t: int, seed: int,
                   poll: bool, row0: int = 0, partial: bool = False):
    """The counter round's read pass (counter.py's ``_round`` up to the
    new ``kv`` and the message ledger).  Per row, after the ``gate`` byte
    (:data:`GATE_WIPE` rows read 0, :data:`GATE_BLOCKED` rows do not
    reach; None: neither): ``want = pending > 0 & reach``.

    - cas: the winner is the least ``(priority, row)`` over the rows that
      want and read fresh (``cached == kv0``) — :func:`counter_priority`,
      one 64-bit key, the same winner in both layouts as the reference's
      packed key and its two-step wide argmin — and ``kv = kv0 +
      pending[winner]`` (``kv0`` when none wins);
    - allreduce: ``kv = kv0 + sum of the wanting rows' pending``, both
      wrapping as int32 sums do; ``cached`` is not read.

    ``msgs + 4 want + 2 (polled and not won)`` mod 2^32, polled = reach
    on a ``poll`` round.  ``kv0`` (0-dim int32) and ``msgs`` (0-dim
    int64) are device scalars, never read on the host; returns new ones
    ``(kv, msgs)`` and leaves the winner row (N: none) in word 3 of
    ``work`` (:func:`counter_work`) for :func:`counter_apply`.  On the
    card the last block to finish finalizes them: no host sync.

    ``partial`` (a rank's block of a mesh, its rows the global rows
    ``row0 ..``, which the hash and the key take): instead of finalizing,
    returns the block's (3,) int64 partial ``[least key in int64 order
    (int64 max: none), cas: that row's pending (0: none) / allreduce: the
    wanting rows' uint32 sum, 4 want + 2 polled]``, polled in cas mode
    every reaching row of a poll round; ``msgs`` and ``work`` word 3 are
    then not written.  The caller reduces the partials over the ranks
    and finishes the round (counter.py)."""
    kw = dict(cas=cas, wide=wide, row_bits=row_bits, t=t, seed=seed,
              poll=poll, row0=row0, partial=partial)
    if cas and not wide and not 1 <= row_bits <= 23:
        raise ValueError(f"packed winner keys take 1..23 row bits, got "
                         f"{row_bits}")
    if row0 < 0 or (row0 and not partial):
        raise ValueError(f"row0 = {row0}: the full read pass takes the "
                         "rows from 0, a block of a mesh the partial form")
    if row0 + pending.shape[0] >= 1 << 31:
        raise ValueError(f"rows {row0} + {pending.shape[0]}: the counter "
                         "round takes < 2^31")
    if _check_counter(pending, cached, gate, work,
                      {"kv0": (kv0, torch.int32),
                       "msgs": (msgs, torch.int64)}):
        return counter_select_plain(pending, cached, gate, kv0, msgs, work,
                                    **kw)
    dev = pending.device
    part = torch.empty(3, dtype=torch.int64, device=dev) if partial \
        else None
    kv = None if partial else torch.empty((), dtype=torch.int32, device=dev)
    msgs_out = None if partial else torch.empty((), dtype=torch.int64,
                                                device=dev)
    _launch("counter_select", _lib("counter_round").gg_counter_select,
            dev, pending.data_ptr(), cached.data_ptr(),
            None if gate is None else gate.data_ptr(), kv0.data_ptr(),
            msgs.data_ptr(), work.data_ptr(),
            None if kv is None else kv.data_ptr(),
            None if msgs_out is None else msgs_out.data_ptr(),
            None if part is None else part.data_ptr(), pending.shape[0],
            row0, (t + seed) & MASK32, int(cas), int(wide), row_bits,
            int(poll))
    return part if partial else (kv, msgs_out)


def counter_apply(pending: torch.Tensor, cached: torch.Tensor,
                  gate: torch.Tensor | None, kv: torch.Tensor,
                  work: torch.Tensor, *, cas: bool, poll: bool,
                  stale_num: int = 0, stale_seed: int = 0, t: int = 0,
                  out=None, row0: int = 0):
    """The counter round's update pass, after :func:`counter_select` on
    the same operands: drain the winner row (cas, word 3 of ``work``) or
    every wanting row (allreduce), and set ``cached`` to the new ``kv``
    where the row wanted, won or was polled — except, with ``stale_num``
    (the round's seq-kv stale threshold, 0: off), a row that did not win,
    is behind and whose :func:`.kvstore.stale_coin` of ``(stale_seed,
    t)`` is below it keeps its value.  Returns ``(pending, cached)``, new
    tensors, or ``out``'s pair written in place (which may be the inputs
    themselves: each row reads and writes only its own words).  ``row0``:
    the global row of row 0 (a rank's block of a mesh), which the winner
    word and the stale coin name."""
    kw = dict(cas=cas, poll=poll, stale_num=stale_num,
              stale_seed=stale_seed, t=t, row0=row0)
    if row0 < 0 or row0 + pending.shape[0] >= 1 << 31:
        raise ValueError(f"rows {row0} + {pending.shape[0]}: the counter "
                         "round takes < 2^31")
    on_cpu = _check_counter(pending, cached, gate, work,
                            {"kv": (kv, torch.int32)})
    if out is not None:
        for x in out:
            if x.dtype != torch.int32 or x.shape != pending.shape \
                    or not x.is_contiguous() or x.device != pending.device:
                raise ValueError("out must be two contiguous (N,) int32 "
                                 "tensors beside pending")
    if on_cpu:
        return counter_apply_plain(pending, cached, gate, kv, work,
                                   out=out, **kw)
    if out is None:
        out = (torch.empty_like(pending), torch.empty_like(cached))
    from .kvstore import stale_key

    _launch("counter_apply", _lib("counter_round").gg_counter_apply,
            pending.device, pending.data_ptr(), cached.data_ptr(),
            None if gate is None else gate.data_ptr(), kv.data_ptr(),
            work.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            pending.shape[0], row0, int(cas), int(poll), stale_num & MASK32,
            stale_key(stale_seed, t))
    return out


# -- the Kafka round (kafka_round.cu) --------------------------------------


def top_off(words: torch.Tensor) -> torch.Tensor:
    """(..., Wc) int32 words -> (...) int32: the offset of the highest set
    bit (bit c of word w is offset 32 w + c + 1), 0 where none is — the
    reference's count-leading-zeros ``top_off``, the bit length taken from
    ``frexp`` of the word as float64 (exact for 32-bit words)."""
    _, e = torch.frexp((words.to(torch.int64) & MASK32).to(torch.float64))
    base = torch.arange(words.shape[-1], dtype=torch.int32,
                        device=words.device) * 32
    return torch.where(words != 0, base + e, 0).amax(dim=-1)


def or_rows(x: torch.Tensor) -> torch.Tensor:
    """The OR over axis 0 of an int32 bitset tensor, by halving."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] | x[h:2 * h]
        if x.shape[0] % 2:
            y[0] |= x[2 * h]
        x = y
    return x[0]


def and_rows(x: torch.Tensor) -> torch.Tensor:
    """The AND over axis 0 of an int32 bitset tensor, by halving (all
    ones over no rows)."""
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], -1, dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] & x[h:2 * h]
        if x.shape[0] % 2:
            y[0] &= x[2 * h]
        x = y
    return x[0]


def kafka_merge_plain(present: torch.Tensor, lc: torch.Tensor, *,
                      wipe=None, row=None, carry=None, own=None,
                      resync: int = RESYNC_NONE, live=None, origin=None):
    d = None
    for part in (None if row is None else row[None], carry, own):
        if part is not None:
            d = part if d is None else d | part
    if wipe is not None:
        present.masked_fill_(wipe[:, None, None], 0)
        lc.masked_fill_(wipe[:, None], 0)
    if d is not None:
        present |= d
        torch.maximum(lc, top_off(d), out=lc)
    if resync == RESYNC_NONE:
        return None, None
    src = present if resync == RESYNC_PULL else origin
    union = or_rows(torch.where(live[:, None, None], src, 0))
    if resync == RESYNC_PULL:
        return union, None
    return union, (origin != 0).flatten(1).any(1).to(torch.int32)


def kafka_nem_deliver_plain(deliver: torch.Tensor, widx: torch.Tensor,
                            bit: torch.Tensor, up: torch.Tensor, *,
                            s_dim: int, lo: int, hi: int, t: int, seed: int,
                            loss_num: int, row0: int = 0, origin0: int = 0,
                            accumulate: bool = False) -> None:
    from .faults import _SALT_LOSS, _hash32

    n, k, wc = deliver.shape
    kw = k * wc
    dst = row0 + torch.arange(lo, hi, device=deliver.device)
    origin = origin0 + torch.arange(widx.shape[0],
                                    device=deliver.device) // s_dim
    # the slab's whole (rows, M S) coin tensor: a destination that is up
    # keeps what the loss coin of origin -> dst lets through, and every
    # node its own appends
    recv = up[lo:hi][:, None] | (origin[None, :] == dst[:, None])
    if loss_num:
        recv &= (_hash32(seed, t, origin[None, :], dst[:, None], _SALT_LOSS)
                 >= loss_num) | (origin[None, :] == dst[:, None])
    idx = torch.where(widx >= 0, widx, kw).to(torch.int64)
    slab = torch.zeros(hi - lo, kw + 1, dtype=torch.int32,
                       device=deliver.device)
    slab.scatter_add_(1, idx.expand(hi - lo, -1).contiguous(),
                      torch.where(recv, bit[None, :], 0))
    if accumulate:
        deliver[lo:hi] |= slab[:, :kw].view(hi - lo, k, wc)
    else:
        deliver[lo:hi] = slab[:, :kw].view(hi - lo, k, wc)


def _commit_masks(lc, req, want_ok, reach, kv_sent):
    """(active, blocked, read_only, need_cas, writers), each (N, K) bool:
    the commit classification of kafka.py's round against ``kv_sent``."""
    want = req >= 1
    if want_ok is not None:
        want = want & want_ok[:, None]
    dance = want & ~((lc > 0) & (lc >= req))
    active = dance & reach[:, None]
    exists = kv_sent[None, :] > 0
    read_only = active & exists & (req <= kv_sent[None, :])
    need_cas = active & exists & (req > kv_sent[None, :])
    return active, dance & ~reach[:, None], read_only, need_cas, \
        active & ~exists


def kafka_commit_select_plain(present: torch.Tensor, lc: torch.Tensor, *,
                              take=None, union=None, req=None, want_ok=None,
                              reach=None, kv_sent=None, tally=None,
                              row0: int = 0, n_total: int | None = None):
    n, k = lc.shape
    nt = n if n_total is None else n_total
    dev = lc.device
    if take is not None:
        sync_new = torch.where(take[:, None, None], union[None] & ~present, 0)
        present |= sync_new
        torch.maximum(lc, top_off(sync_new), out=lc)
    counts = torch.zeros(KAFKA_COUNTS, dtype=torch.int64, device=dev)
    if tally is not None:
        counts[3] = tally.sum()
    cas_win = torch.full((k,), nt + 1, dtype=torch.int32, device=dev)
    wrt_last = torch.full((k,), -1, dtype=torch.int32, device=dev)
    if req is not None:
        active, blocked, _, need_cas, writers = _commit_masks(
            lc, req, want_ok, reach, kv_sent)
        rows = row0 + torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        cas_win = torch.where(need_cas, rows, nt + 1).amin(0).to(torch.int32)
        wrt_last = torch.where(writers, rows, -1).amax(0).to(torch.int32)
        counts[0] = active.sum()
        counts[1] = blocked.sum()
        counts[2] = (need_cas | writers).sum()
    return cas_win, wrt_last, counts


def kafka_commit_apply_plain(lc: torch.Tensor, req: torch.Tensor,
                             cas_win: torch.Tensor, wrt_last: torch.Tensor,
                             kv_sent: torch.Tensor, reach: torch.Tensor,
                             want_ok, counts: torch.Tensor | None,
                             msgs: torch.Tensor | None, *, kv_retries: int,
                             tally_mult: int, row0: int = 0,
                             n_total: int | None = None,
                             partial: bool = False):
    n = lc.shape[0]
    nt = n if n_total is None else n_total
    _, _, read_only, need_cas, writers = _commit_masks(lc, req, want_ok,
                                                       reach, kv_sent)
    rows = row0 + torch.arange(n, dtype=torch.int32,
                               device=lc.device)[:, None]
    learn = torch.where(need_cas & (rows == cas_win[None, :]), req,
                        torch.where(read_only, kv_sent[None, :],
                                    torch.where(writers, req, 0)))
    torch.maximum(lc, learn, out=lc)

    def req_at(r):
        # the request of global row r where it lies in this block, else 0
        loc = r.to(torch.int64) - row0
        inb = (loc >= 0) & (loc < n)
        got = req.gather(0, loc.clamp(0, n - 1)[None])[0]
        return torch.where(inb, got, 0)

    if partial:
        return torch.stack([torch.where(cas_win <= nt - 1, req_at(cas_win),
                                        0),
                            torch.where(wrt_last >= 0, req_at(wrt_last),
                                        0)])
    return commit_finish(torch.stack([req_at(cas_win), req_at(wrt_last)]),
                         cas_win, wrt_last, kv_sent, counts, msgs,
                         kv_retries=kv_retries, tally_mult=tally_mult,
                         n_total=nt)


def commit_finish(part: torch.Tensor, cas_win: torch.Tensor,
                  wrt_last: torch.Tensor, kv_sent: torch.Tensor,
                  counts: torch.Tensor, msgs: torch.Tensor, *,
                  kv_retries: int, tally_mult: int, n_total: int):
    """The new cells and ledger from :func:`kafka_commit_apply`'s partial
    form summed over the blocks (``part`` (2, K): the CAS winner's and the
    last writer's requests) and the blocks' summed ``counts``: the
    winner's request where a CAS won, else the last writer's, else
    ``kv_sent``; ``msgs`` plus the counts' charges, mod 2^32."""
    kv_val = torch.where(cas_win <= n_total - 1, part[0],
                         torch.where(wrt_last >= 0, part[1], kv_sent))
    inc = (2 * counts[0] + kv_retries * counts[1] + 2 * counts[2]
           + tally_mult * counts[3])
    return kv_val.to(torch.int32), (msgs + inc) & MASK32


def _check_kafka(present: torch.Tensor, lc: torch.Tensor) -> tuple:
    """Validate the Kafka state pair; returns (n, k, wc)."""
    if present.dtype != torch.int32 or present.dim() != 3 \
            or not present.is_contiguous():
        raise ValueError(f"present must be a contiguous (N, K, Wc) int32 "
                         f"tensor, got {present.dtype} "
                         f"{tuple(present.shape)}")
    n, k, wc = present.shape
    if not (1 <= n <= MAX_NODES and k >= 1 and 1 <= wc <= KAFKA_MAX_WORDS):
        raise ValueError(f"(N, K, Wc) = {tuple(present.shape)}: the Kafka "
                         f"kernels take 1 <= N < 2^31, K >= 1 and 1 <= Wc "
                         f"<= {KAFKA_MAX_WORDS}")
    _check_like("lc", lc, (n, k), torch.int32)
    return n, k, wc


def _check_like(name: str, x, shape: tuple, dtype: torch.dtype) -> None:
    if x is not None and (x.dtype != dtype or tuple(x.shape) != shape
                          or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _bytes(x):
    """A bool row's pointer as bytes (None passes through)."""
    return None if x is None else x.view(torch.uint8).data_ptr()


def _ptr(x):
    return None if x is None else x.data_ptr()


def kafka_merge(present: torch.Tensor, lc: torch.Tensor, *,
                wipe: torch.Tensor | None = None,
                row: torch.Tensor | None = None,
                carry: torch.Tensor | None = None,
                own: torch.Tensor | None = None,
                resync: int = RESYNC_NONE, live: torch.Tensor | None = None,
                origin: torch.Tensor | None = None):
    """The Kafka round's merge pass over ``present`` (N, K, Wc) int32 and
    the committed-offset cache ``lc`` (N, K) int32, both in place:

    - the amnesia wipe: rows with ``wipe`` (N,) bool lose both;
    - the delivery ``d``, the OR of what is given: ``row`` (K, Wc), the
      union row every node receives; ``carry`` (N, K, Wc), each row's
      own delivery; ``own`` (N, K, Wc), each node's own appends;
      ``present |= d`` and ``lc = max(lc, top_off(d))``;
    - on a resync round, the union (K, Wc) over the ``live`` (N,) bool
      rows of the presence after delivery (:data:`RESYNC_PULL`) or of
      ``origin`` (:data:`RESYNC_PUSH`, which also flags each row holding
      any origin bit, (N,) int32 0 / 1).

    Returns ``(union, any_origin)``, None for what the mode does not
    make.  On the card a key whose delivery words are 0 reads no
    presence, unless the row is wiped or the pass pulls."""
    n, k, wc = _check_kafka(present, lc)
    _check_like("wipe", wipe, (n,), torch.bool)
    _check_like("row", row, (k, wc), torch.int32)
    for name, x in (("carry", carry), ("own", own), ("origin", origin)):
        _check_like(name, x, (n, k, wc), torch.int32)
    _check_like("live", live, (n,), torch.bool)
    if resync not in (RESYNC_NONE, RESYNC_PULL, RESYNC_PUSH):
        raise ValueError(f"unknown resync mode {resync}")
    if resync != RESYNC_NONE and live is None:
        raise ValueError("a resync pass needs the live rows")
    if resync == RESYNC_PUSH and origin is None:
        raise ValueError("a push resync needs the origin bits")
    if carry is not None and _overlap(carry, present) \
            or own is not None and _overlap(own, present):
        raise ValueError("carry and own must not alias present")
    xs = [x for x in (present, lc, wipe, row, carry, own, live, origin)
          if x is not None]
    if _on_cpu(*xs):
        return kafka_merge_plain(present, lc, wipe=wipe, row=row,
                                 carry=carry, own=own, resync=resync,
                                 live=live, origin=origin)
    union = any_origin = None
    if resync != RESYNC_NONE:
        union = torch.zeros(k, wc, dtype=torch.int32, device=present.device)
    if resync == RESYNC_PUSH:
        any_origin = torch.zeros(n, dtype=torch.int32, device=present.device)
    _launch("kafka_merge", _lib("kafka_round").gg_kafka_merge,
            present.device, present.data_ptr(), lc.data_ptr(), _bytes(wipe),
            _ptr(row), _ptr(carry), _ptr(own), _bytes(live), _ptr(origin),
            _ptr(union), _ptr(any_origin), n, k, wc, resync)
    return union, any_origin


def kafka_nem_deliver(deliver: torch.Tensor, widx: torch.Tensor,
                      bit: torch.Tensor, up: torch.Tensor, *, s_dim: int,
                      lo: int, hi: int, t: int, seed: int, loss_num: int,
                      row0: int = 0, origin0: int = 0,
                      accumulate: bool = False) -> None:
    """The faulted origin union of the destination rows [lo, hi), written
    into those rows of ``deliver`` (N, K, Wc) int32: over M S sends (send
    m from origin ``origin0 + m // s_dim``; ``widx`` (M S,) int32 its
    word ``key * Wc + word``, -1 for none; ``bit`` its word's bit, 0 for
    none), row ``dst`` (global id ``row0 + dst``) gets the bits of the
    sends with ``(up[dst] and not drop(t, origin, row0 + dst)) or origin
    == row0 + dst``.  ``drop`` is the reference's ``edge_drop`` coin, the
    hash of ``(seed, t, origin, dst)`` below ``loss_num`` (0 when the
    loss stream is off at ``t``).  ``accumulate``: OR the bits into the
    rows instead of overwriting them.

    Off a mesh the M origins are the N rows (``row0 = origin0 = 0``).
    The block form, on a mesh rank's N rows: ``row0`` the block's first
    global row, the origins all N of the sim (the materialized union) or
    one visiting rank's block at ``origin0`` (the ring, each step
    accumulating).  No coin tensor: on the card each block hashes one
    row's sends in registers."""
    if deliver.dtype != torch.int32 or deliver.dim() != 3 \
            or not deliver.is_contiguous():
        raise ValueError("deliver must be a contiguous (N, K, Wc) int32 "
                         "tensor")
    n, k, wc = deliver.shape
    if s_dim < 1 or widx.dim() != 1 or widx.shape[0] % s_dim:
        raise ValueError(f"widx must hold M x {s_dim} sends, got "
                         f"{tuple(widx.shape)}")
    m = widx.shape[0] // s_dim
    _check_like("widx", widx, (m * s_dim,), torch.int32)
    _check_like("bit", bit, (m * s_dim,), torch.int32)
    _check_like("up", up, (n,), torch.bool)
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"rows [{lo}, {hi}) outside [0, {n}]")
    if row0 < 0 or origin0 < 0 or row0 + n > MAX_NODES \
            or origin0 + m > MAX_NODES:
        raise ValueError(f"row0 {row0} + N {n} and origin0 {origin0} + M "
                         f"{m}: global ids are below 2^31")
    if _on_cpu(deliver, widx, bit, up):
        return kafka_nem_deliver_plain(
            deliver, widx, bit, up, s_dim=s_dim, lo=lo, hi=hi, t=t,
            seed=seed, loss_num=loss_num, row0=row0, origin0=origin0,
            accumulate=accumulate)
    if not (1 <= n <= MAX_NODES and m * s_dim <= MAX_NODES):
        raise ValueError(f"N = {n} and M S = {m * s_dim} sends: the kernel "
                         f"takes below 2^31")
    from .faults import _K_T, _SALT_LOSS

    if hi > lo:
        key = ((t & MASK32) * _K_T & MASK32) ^ (seed & MASK32) ^ _SALT_LOSS
        _launch("kafka_nem_deliver", _lib("kafka_round").gg_kafka_nem_deliver,
                deliver.device, deliver.data_ptr(), widx.data_ptr(),
                bit.data_ptr(), _bytes(up), n, k, wc, s_dim, m, lo, hi,
                row0, origin0, int(accumulate), key, loss_num & MASK32)


def kafka_commit_select(present: torch.Tensor, lc: torch.Tensor, *,
                        take: torch.Tensor | None = None,
                        union: torch.Tensor | None = None,
                        req: torch.Tensor | None = None,
                        want_ok: torch.Tensor | None = None,
                        reach: torch.Tensor | None = None,
                        kv_sent: torch.Tensor | None = None,
                        tally: torch.Tensor | None = None, row0: int = 0,
                        n_total: int | None = None):
    """The Kafka round's commit read pass, after :func:`kafka_merge`, in
    place on ``present`` and ``lc``:

    - the resync take: rows with ``take`` (N,) bool gain ``union & ~present``
      (the (K, Wc) union of the merge pass) and max-bump ``lc`` to its
      top offset;
    - the commit classification of ``req`` (N, K) int32 (-1: none)
      against the high-water mark ``lc`` and the cells after the sends
      ``kv_sent`` (K,): a node that is up (``want_ok``, None: all) wants
      a commit of ``req >= 1``; it dances unless ``0 < lc >= req``; a
      dance is active where the node ``reach``-es the KV, else blocked;
      an active dance reads only where the cell exists and covers
      ``req``, needs the CAS where it exists and does not, and writes
      where it does not exist.

    Returns ``(cas_win, wrt_last, counts)``: per key the lowest CAS row
    (N + 1: none) and the highest writer row (-1: none), (K,) int32, and
    four int64 counts (:data:`KAFKA_COUNTS`: active dances, blocked
    dances, write legs, ``tally`` rows).  On the card each block reduces
    its keys over its node rows first and adds one atomic a key.

    The block form, on a mesh rank's N rows: ``row0`` the global id of
    row 0 and ``n_total`` the sim's N, so the rows are global ids and
    the sentinel is ``n_total + 1``; the mesh takes the minimum of the
    blocks' ``cas_win``, the maximum of their ``wrt_last`` and the sum
    of their counts."""
    n, k, wc = _check_kafka(present, lc)
    nt = n if n_total is None else n_total
    if row0 < 0 or row0 + n > nt or nt >= MAX_NODES:
        raise ValueError(f"rows [{row0}, {row0 + n}) of {nt}: the block "
                         f"lies inside the sim's N < 2^31 - 1")
    for name, x in (("take", take), ("want_ok", want_ok), ("reach", reach),
                    ("tally", tally)):
        _check_like(name, x, (n,), torch.bool)
    _check_like("union", union, (k, wc), torch.int32)
    _check_like("req", req, (n, k), torch.int32)
    _check_like("kv_sent", kv_sent, (k,), torch.int32)
    if take is not None and union is None:
        raise ValueError("a resync take needs the union")
    if req is not None and (reach is None or kv_sent is None):
        raise ValueError("the commit classification needs reach and "
                         "kv_sent")
    xs = [x for x in (present, lc, take, union, req, want_ok, reach,
                      kv_sent, tally) if x is not None]
    if _on_cpu(*xs):
        return kafka_commit_select_plain(present, lc, take=take, union=union,
                                         req=req, want_ok=want_ok,
                                         reach=reach, kv_sent=kv_sent,
                                         tally=tally, row0=row0,
                                         n_total=nt)
    dev = present.device
    cas_win = torch.full((k,), nt + 1, dtype=torch.int32, device=dev)
    wrt_last = torch.full((k,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(KAFKA_COUNTS, dtype=torch.int64, device=dev)
    _launch("kafka_commit_select", _lib("kafka_round").gg_kafka_commit_select,
            dev, present.data_ptr(), lc.data_ptr(), _bytes(take),
            _ptr(union), _ptr(req), _bytes(want_ok), _bytes(reach),
            _ptr(kv_sent), _bytes(tally), cas_win.data_ptr(),
            wrt_last.data_ptr(), counts.data_ptr(), n, k, wc, row0)
    return cas_win, wrt_last, counts


def kafka_commit_apply(lc: torch.Tensor, req: torch.Tensor,
                       cas_win: torch.Tensor, wrt_last: torch.Tensor,
                       kv_sent: torch.Tensor, reach: torch.Tensor,
                       want_ok: torch.Tensor | None,
                       counts: torch.Tensor | None,
                       msgs: torch.Tensor | None, *, kv_retries: int,
                       tally_mult: int, row0: int = 0,
                       n_total: int | None = None, partial: bool = False):
    """The Kafka round's commit write pass, after
    :func:`kafka_commit_select` on the same operands: ``lc = max(lc,
    learn)`` in place, where a node learns its request if it won its
    key's CAS or wrote, the cell if it only read, else nothing.  Returns
    the new cells (K,) int32 — the CAS winner's request, else the last
    writer's, else ``kv_sent`` — and ``(msgs + 2 active + kv_retries
    blocked + 2 write legs + tally_mult tally) mod 2^32`` as a 0-dim
    int64 (``msgs`` 0-dim int64, never read on the host).

    The block form, on a mesh rank's N rows (``row0`` the global id of
    row 0, ``n_total`` the sim's N; ``cas_win`` / ``wrt_last`` the
    mesh's, in global ids): with ``partial`` it returns (2, K) int32, the
    CAS winner's and the last writer's requests where those rows lie in
    the block and 0 elsewhere (``counts`` and ``msgs`` unused), which the
    mesh sums over the blocks and :func:`commit_finish` turns into the
    cells and the ledger."""
    n, k = lc.shape
    nt = n if n_total is None else n_total
    if row0 < 0 or row0 + n > nt or nt >= MAX_NODES:
        raise ValueError(f"rows [{row0}, {row0 + n}) of {nt}: the block "
                         f"lies inside the sim's N < 2^31 - 1")
    _check_like("lc", lc, (n, k), torch.int32)
    _check_like("req", req, (n, k), torch.int32)
    for name, x in (("cas_win", cas_win), ("wrt_last", wrt_last),
                    ("kv_sent", kv_sent)):
        _check_like(name, x, (k,), torch.int32)
    _check_like("reach", reach, (n,), torch.bool)
    _check_like("want_ok", want_ok, (n,), torch.bool)
    if not partial:
        _check_like("counts", counts, (KAFKA_COUNTS,), torch.int64)
        if msgs is None or msgs.dtype != torch.int64 or msgs.dim() != 0:
            raise ValueError("msgs must be a 0-dim int64 tensor")
    if not (1 <= n <= MAX_NODES and k >= 1):
        raise ValueError(f"(N, K) = {(n, k)}: the kernel takes 1 <= N < "
                         f"2^31 and K >= 1")
    xs = [x for x in (lc, req, cas_win, wrt_last, kv_sent, reach, want_ok)
          + ((counts, msgs) if not partial else ()) if x is not None]
    kw = dict(kv_retries=kv_retries, tally_mult=tally_mult, row0=row0,
              n_total=nt, partial=partial)
    if _on_cpu(*xs):
        return kafka_commit_apply_plain(lc, req, cas_win, wrt_last, kv_sent,
                                        reach, want_ok, counts, msgs, **kw)
    if partial:
        out = torch.empty((2, k), dtype=torch.int32, device=lc.device)
        _launch("kafka_commit_apply",
                _lib("kafka_round").gg_kafka_commit_apply, lc.device,
                lc.data_ptr(), req.data_ptr(), cas_win.data_ptr(),
                wrt_last.data_ptr(), kv_sent.data_ptr(), _bytes(reach),
                _bytes(want_ok), None, None, out.data_ptr(), None, n, k,
                row0, nt, 1, kv_retries, tally_mult)
        return out
    kv_val = torch.empty_like(kv_sent)
    msgs_out = torch.empty_like(msgs)
    _launch("kafka_commit_apply", _lib("kafka_round").gg_kafka_commit_apply,
            lc.device, lc.data_ptr(), req.data_ptr(), cas_win.data_ptr(),
            wrt_last.data_ptr(), kv_sent.data_ptr(), _bytes(reach),
            _bytes(want_ok), counts.data_ptr(), msgs.data_ptr(),
            kv_val.data_ptr(), msgs_out.data_ptr(), n, k, row0, nt, 0,
            kv_retries, tally_mult)
    return kv_val, msgs_out


# -- the traffic drivers' completion predicate (traffic_fold.cu) ----------


def and_fold_plain(x: torch.Tensor, node_major: bool = False) -> torch.Tensor:
    return and_rows(x if node_major else x.t())


def and_fold(x: torch.Tensor, node_major: bool = False) -> torch.Tensor:
    """(W,) int32: the AND over the node axis of a (W, N) words-major
    bitset, or of an (N, C) node-major one with ``node_major`` (Kafka's
    (N, K, Wc) presence viewed as (N, K Wc)): the words every node
    holds.  All ones over no nodes."""
    _check_bitset("x", x)
    if _on_cpu(x):
        return and_fold_plain(x, node_major)
    n, c = x.shape if node_major else x.shape[::-1]
    out = torch.full((c,), -1, dtype=torch.int32, device=x.device)
    if not n or not c:
        return out
    lib = _lib("traffic_fold")
    if node_major and c > 1:
        _launch("and_fold", lib.gg_and_fold_cols, x.device, x.data_ptr(),
                out.data_ptr(), n, c)
    else:
        # a node-major single column is one contiguous row of N words
        _check_words(c)
        _launch("and_fold", lib.gg_and_fold_rows, x.device, x.data_ptr(),
                out.data_ptr(), c, n)
    return out


# -- the provenance record of the gather round (prov_flood.cu) ------------

# ring slots a slot table can name (int8 bytes, -1 none)
PROV_MAX_SLOTS = 127


def _prov_term(d: int, src: torch.Tensor, nbrs: torch.Tensor,
               flags: torch.Tensor | None, dup: torch.Tensor | None,
               slots: torch.Tensor | None) -> torch.Tensor:
    """(N, W) int32: direction ``d``'s delivered words (the gather
    round's inbox term), over indices clipped into the source rows."""
    n_src = src.shape[-2]
    idx = nbrs[:, d].clamp(0, n_src - 1).to(torch.int64)
    if slots is not None:
        s = slots[:, d].to(torch.int64)
        return torch.where((s >= 0)[:, None], src[s.clamp(min=0), idx], 0)
    ok = nbrs[:, d] >= 0 if flags is None else (flags[:, d] & FLAG_DEL) != 0
    term = torch.where(ok[:, None], src[idx], 0)
    if dup is not None:
        term = term | torch.where(((flags[:, d] & FLAG_DUP) != 0)[:, None],
                                  dup[idx], 0)
    return term


def prov_attribute_plain(new: torch.Tensor, src: torch.Tensor,
                         nbrs: torch.Tensor, arrival: torch.Tensor,
                         parent: torch.Tensor, *, t_next: int,
                         flags: torch.Tensor | None = None,
                         dup: torch.Tensor | None = None,
                         slots: torch.Tensor | None = None):
    """The reference's ``_prov_attribute`` (broadcast.py:317-342): the
    new ``(arrival, parent)``, out of place."""
    nv = arrival.shape[1]
    fresh = unpack_bits(new, nv) & (arrival < 0)
    remaining = new
    for d in range(nbrs.shape[1]):
        hit = _prov_term(d, src, nbrs, flags, dup, slots) & remaining
        remaining = remaining & ~hit
        parent = torch.where(unpack_bits(hit, nv) & fresh, nbrs[:, d:d + 1],
                             parent)
    return torch.where(fresh, t_next, arrival), parent


def prov_attribute(new: torch.Tensor, src: torch.Tensor, nbrs: torch.Tensor,
                   arrival: torch.Tensor, parent: torch.Tensor, *,
                   t_next: int, flags: torch.Tensor | None = None,
                   dup: torch.Tensor | None = None,
                   slots: torch.Tensor | None = None):
    """The provenance stamps of one node-major gather round, in place:
    for each bit of ``new`` ((N, W) int32, the round's newly delivered
    bits) whose ``arrival`` cell ((N, V) int32, V <= 32 W) is still
    below 0, ``arrival = t_next`` and ``parent`` = the neighbour
    ``nbrs[i, d]`` of the first direction d whose delivered word carries
    the bit.  A direction's word is, one hop, ``src[nbrs[i, d]]`` ((P, W)
    payload) where the edge's ``flags`` byte has :data:`FLAG_DEL` (no
    flags: where ``nbrs >= 0``), ORed with ``dup[nbrs[i, d]]`` where it
    has :data:`FLAG_DUP`; or, under per-edge delays, ``src[slots[i, d],
    nbrs[i, d]]`` of the (L, P, W) ring where the (N, D) int8 ``slots``
    byte is >= 0.  Returns ``(arrival, parent)``."""
    _check_bitset("new", new)
    _check_table(nbrs, flags, "flags", torch.uint8)
    _check_table(nbrs, slots, "slots", torch.int8)
    n, d = nbrs.shape
    if new.shape[0] != n:
        raise ValueError(f"new {tuple(new.shape)} must have the table's "
                         f"{n} rows")
    w = new.shape[1]
    for name, x in (("arrival", arrival), ("parent", parent)):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != n \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (N, V) int32 "
                             f"tensor with N = {n}")
    nv = arrival.shape[1]
    if parent.shape != arrival.shape or nv > 32 * w:
        raise ValueError(f"parent {tuple(parent.shape)} must match arrival "
                         f"{tuple(arrival.shape)}, V <= 32 W = {32 * w}")
    ring = slots is not None
    if ring and (flags is not None or dup is not None):
        raise ValueError("slots (the delay ring) take no flags or dup rows")
    if dup is not None and flags is None:
        raise ValueError("dup rows need the flag bytes")
    if src.dtype != torch.int32 or src.dim() != (3 if ring else 2) \
            or src.shape[-1] != w or src.shape[-2] < 1 \
            or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous int32 "
                         f"{'(L, P, W)' if ring else '(P, W)'} tensor with "
                         f"W = {w}, got {tuple(src.shape)}")
    if ring and src.shape[0] > PROV_MAX_SLOTS:
        raise ValueError(f"the slot bytes name at most {PROV_MAX_SLOTS} "
                         "ring slots")
    if dup is not None and (dup.dtype != torch.int32
                            or dup.shape != src.shape
                            or not dup.is_contiguous()):
        raise ValueError("dup must be a contiguous int32 tensor shaped "
                         "like src")
    if max(n, src.shape[-2]) > MAX_NODES:
        raise ValueError(f"the kernel takes at most {MAX_NODES} nodes")
    xs = [x for x in (new, src, nbrs, arrival, parent, flags, dup, slots)
          if x is not None]
    if _on_cpu(*xs):
        arr, par = prov_attribute_plain(new, src, nbrs, arrival, parent,
                                        t_next=t_next, flags=flags, dup=dup,
                                        slots=slots)
        arrival.copy_(arr)
        parent.copy_(par)
        return arrival, parent
    edge = slots if ring else flags
    if new.numel() and nv:
        _launch("prov_attribute", _lib("prov_flood").gg_prov_attribute,
                new.device, new.data_ptr(), src.data_ptr(),
                None if dup is None else dup.data_ptr(), nbrs.data_ptr(),
                None if edge is None else edge.data_ptr(),
                arrival.data_ptr(), parent.data_ptr(), n, w, src.shape[-2],
                nv, d, src.shape[-2] * w, int(ring), int(t_next))
    return arrival, parent


# -- the txn-rw-register round (txn_round.cu) ------------------------------

# the claim of no one: an unclaimed key's best priority
TXN_INF = (1 << 31) - 1


def _txn_issue_prio(issue: torch.Tensor, active: torch.Tensor, t: int,
                    row0: int = 0, n_total: int | None = None):
    """(issue, prio): the open transactions' first-attempt rounds after
    this round's first attempts, and their int32 priorities ``issue *
    n_total + row0 + i`` for local row i (``n_total`` the sim's N, default
    the rows given), wrapped mod 2^32 as the reference's int32 product
    wraps."""
    n = issue.shape[0]
    nt = n if n_total is None else n_total
    iss = torch.where(active & (issue < 0), t, issue)
    rows = torch.arange(row0, row0 + n, dtype=torch.int64,
                        device=issue.device)
    return iss, _wrap_i32(iss.to(torch.int64) * nt + rows)


def _txn_open(x: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """(N, O): each node's open slot ``clip(cur, 0, T - 1)`` of an (N, T,
    O) tensor."""
    n, t_dim = x.shape[:2]
    curc = cur.clamp(0, max(t_dim - 1, 0)).to(torch.int64)
    return x[torch.arange(n, device=x.device), curc]


def txn_claim_plain(keys: torch.Tensor, cur: torch.Tensor,
                    issue: torch.Tensor, active: torch.Tensor, *, t: int,
                    n_keys: int, row0: int = 0, n_total: int | None = None):
    """The reference's claim (txn.py:264-279) and its attempts sum; over a
    block of rows from global row ``row0`` of ``n_total`` these are the
    block's partials (a minimum and a sum finish them)."""
    _, prio = _txn_issue_prio(issue, active, t, row0, n_total)
    k_n = _txn_open(keys, cur)
    claim = torch.where(active[:, None], prio[:, None].expand(k_n.shape),
                        TXN_INF)
    best = torch.full((n_keys,), TXN_INF, dtype=torch.int32,
                      device=keys.device)
    best.scatter_reduce_(0, k_n.reshape(-1).to(torch.int64),
                         claim.reshape(-1), "amin")
    return best, active.sum(dtype=torch.int32).reshape(1)


def txn_commit_plain(best: torch.Tensor, keys: torch.Tensor,
                     write: torch.Tensor, wval: torch.Tensor,
                     cur: torch.Tensor, issue: torch.Tensor,
                     active: torch.Tensor, owner: torch.Tensor,
                     slot: torch.Tensor, vals: torch.Tensor,
                     vers: torch.Tensor, op_ver: torch.Tensor,
                     op_val: torch.Tensor, commit_round: torch.Tensor,
                     issue_round: torch.Tensor, *, t: int,
                     view: torch.Tensor | None = None, row0: int = 0,
                     n_total: int | None = None):
    """The reference's winner test, (value, version) view, write requests
    and slot records (txn.py:280-322), out of place: ``(req, cur, issue,
    op_ver, op_val, commit_round, issue_round)``.  ``view``: the (2, K)
    (value, version) view to read instead of ``vals[owner, slot]``;
    ``row0`` / ``n_total``: a block of rows (``req`` is then its
    partial)."""
    n, t_dim, o = keys.shape
    k_dim = best.shape[0]
    dev = keys.device
    iss, prio = _txn_issue_prio(issue, active, t, row0, n_total)
    k_n = _txn_open(keys, cur).to(torch.int64)
    wr_n = _txn_open(write, cur)
    wv_n = _txn_open(wval, cur)
    win = active & (best[k_n] == prio[:, None]).all(dim=1)
    if view is None:
        at = (owner[k_n], slot[k_n])
        rd_val, rd_ver = vals[at], vers[at]
    else:
        rd_val, rd_ver = view[0][k_n], view[1][k_n]
    w_mask = win[:, None] & wr_n
    flat = k_n.reshape(-1)
    req = torch.zeros((3, k_dim), dtype=torch.int32, device=dev)
    for row, x in enumerate((w_mask.to(torch.int32),
                             torch.where(w_mask, wv_n, 0),
                             torch.where(w_mask, rd_ver, 0))):
        req[row].index_add_(0, flat, x.reshape(-1))
    ar = torch.arange(n, device=dev)
    curc = cur.clamp(0, max(t_dim - 1, 0)).to(torch.int64)
    new_ver = torch.where(wr_n, _wrap_i32(rd_ver.to(torch.int64) + 1), rd_ver)
    new_val = torch.where(wr_n, wv_n, rd_val)
    op_ver, op_val = op_ver.clone(), op_val.clone()
    commit_round, issue_round = commit_round.clone(), issue_round.clone()
    op_ver[ar[win], curc[win]] = new_ver[win]
    op_val[ar[win], curc[win]] = new_val[win]
    commit_round[ar[win], curc[win]] = t
    first = active & (issue < 0)
    issue_round[ar[first], curc[first]] = t
    return (req, cur + win.to(torch.int32), torch.where(win, -1, iss),
            op_ver, op_val, commit_round, issue_round)


def _check_txn_nodes(keys: torch.Tensor, **rows) -> tuple[int, int, int]:
    """(N, T, O) of the (N, T, O) int32 ``keys``, each (N,) row checked."""
    if keys.dtype != torch.int32 or keys.dim() != 3 \
            or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous (N, T, O) int32 "
                         f"tensor, got {keys.dtype} {tuple(keys.shape)}")
    n, t_dim, o = keys.shape
    if n > MAX_NODES or t_dim < 1:
        raise ValueError(f"the txn kernels take at most {MAX_NODES} nodes "
                         f"and T >= 1 slots, got {tuple(keys.shape)}")
    for name, (x, dtype) in rows.items():
        _check_like(name, x, (n,), dtype)
    return n, t_dim, o


def _txn_block(n: int, row0: int, n_total: int | None) -> int:
    """The sim's N of a block of ``n`` rows from global row ``row0``
    (``n_total`` None: the rows are the whole problem), checked."""
    nt = n if n_total is None else int(n_total)
    if row0 < 0 or row0 + n > nt or nt > MAX_NODES:
        raise ValueError(f"rows [{row0}, {row0 + n}) do not lie in a "
                         f"problem of {nt} nodes (at most {MAX_NODES})")
    return nt


def txn_claim(keys: torch.Tensor, cur: torch.Tensor, issue: torch.Tensor,
              active: torch.Tensor, *, t: int, n_keys: int, row0: int = 0,
              n_total: int | None = None):
    """The wound-or-die claim of one txn round: each ``active`` node
    ((N,) bool) claims the keys of its open slot ``clip(cur, 0, T - 1)``
    of ``keys`` ((N, T, O) int32, in [0, ``n_keys``)) at its priority
    ``issue' * N + node`` (int32, wrapped), ``issue'`` being ``t`` for a
    first attempt (``issue < 0``) and ``issue`` else.  Returns ``(best,
    attempts)``: (K,) int32, each key's least claim (:data:`TXN_INF`
    where none), and (1,) int32, the active nodes.  Block form (a mesh
    rank's rows): the rows are global rows ``row0 ..`` of a problem of
    ``n_total`` nodes, so the priority is ``issue' * n_total + row0 +
    i``, and both results are the block's partials, for a minimum and a
    sum across the blocks."""
    n, _, o = _check_txn_nodes(keys, cur=(cur, torch.int32),
                               issue=(issue, torch.int32),
                               active=(active, torch.bool))
    nt = _txn_block(n, row0, n_total)
    if _on_cpu(keys, cur, issue, active):
        return txn_claim_plain(keys, cur, issue, active, t=t, n_keys=n_keys,
                               row0=row0, n_total=nt)
    best = torch.full((n_keys,), TXN_INF, dtype=torch.int32,
                      device=keys.device)
    attempts = torch.zeros(1, dtype=torch.int32, device=keys.device)
    if n:
        _launch("txn_claim", _lib("txn_round").gg_txn_claim, keys.device,
                keys.data_ptr(), cur.data_ptr(), issue.data_ptr(),
                _bytes(active), best.data_ptr(), attempts.data_ptr(), n,
                keys.shape[1], o, n_keys, int(t), int(row0), nt)
    return best, attempts


def txn_commit(best: torch.Tensor, keys: torch.Tensor, write: torch.Tensor,
               wval: torch.Tensor, cur: torch.Tensor, issue: torch.Tensor,
               active: torch.Tensor, owner: torch.Tensor | None,
               slot: torch.Tensor | None, vals: torch.Tensor | None,
               vers: torch.Tensor | None, op_ver: torch.Tensor,
               op_val: torch.Tensor, commit_round: torch.Tensor,
               issue_round: torch.Tensor, *, t: int,
               view: torch.Tensor | None = None, row0: int = 0,
               n_total: int | None = None) -> torch.Tensor:
    """The commit of one txn round, after :func:`txn_claim`'s ``best``:
    a node wins iff it is active and ``best`` of every key of its open
    slot equals its priority; it reads each key's (value, version) at
    ``(owner[k], slot[k])`` of the store's (N, cap) ``vals`` / ``vers``.
    In place: a winner's ``op_ver`` / ``op_val`` ((N, T, O)) at its open
    slot become the versions and values it installs (``ver + 1`` and
    ``wval`` for a ``write`` op) or read, its ``commit_round`` ((N, T))
    there becomes ``t``; a first attempt stamps ``issue_round`` there;
    ``cur`` += win, ``issue`` = -1 for a winner and ``issue'`` else.
    Returns the (3, K) int32 write requests, sums over the winners' write
    ops (count, value, version read), as the reference's scatter-adds.
    Block form (a mesh rank's rows): ``row0`` / ``n_total`` as in
    :func:`txn_claim`, ``best`` the minimum over the blocks, ``view`` the
    (2, K) int32 (value, version) view of every rank's store rows (read in
    place of the rows, which may then be None), and the requests the
    block's partial, summed across the blocks."""
    n, t_dim, o = _check_txn_nodes(keys, cur=(cur, torch.int32),
                                   issue=(issue, torch.int32),
                                   active=(active, torch.bool))
    nt = _txn_block(n, row0, n_total)
    _check_like("write", write, (n, t_dim, o), torch.bool)
    for name, x in (("wval", wval), ("op_ver", op_ver), ("op_val", op_val)):
        _check_like(name, x, (n, t_dim, o), torch.int32)
    for name, x in (("commit_round", commit_round),
                    ("issue_round", issue_round)):
        _check_like(name, x, (n, t_dim), torch.int32)
    k_dim = best.shape[0]
    _check_like("best", best, (k_dim,), torch.int32)
    if view is not None:
        _check_like("view", view, (2, k_dim), torch.int32)
        xs = (best, keys, write, wval, cur, issue, active, view, op_ver,
              op_val, commit_round, issue_round)
    else:
        for name, x in (("owner", owner), ("slot", slot)):
            _check_like(name, x, (k_dim,), torch.int64)
        if vals.dtype != torch.int32 or vals.dim() != 2 \
                or not vals.is_contiguous():
            raise ValueError("vals must be a contiguous (N, cap) int32 "
                             "tensor")
        _check_like("vers", vers, tuple(vals.shape), torch.int32)
        xs = (best, keys, write, wval, cur, issue, active, owner, slot,
              vals, vers, op_ver, op_val, commit_round, issue_round)
    if _on_cpu(*xs):
        out = txn_commit_plain(best, keys, write, wval, cur, issue, active,
                               owner, slot, vals, vers, op_ver, op_val,
                               commit_round, issue_round, t=t, view=view,
                               row0=row0, n_total=nt)
        for dst, src in zip((cur, issue, op_ver, op_val, commit_round,
                             issue_round), out[1:]):
            dst.copy_(src)
        return out[0]
    req = torch.zeros((3, k_dim), dtype=torch.int32, device=keys.device)
    if view is not None:
        # the kernel reads the view alone
        owner = slot = vals = vers = None
    if n:
        _launch("txn_commit", _lib("txn_round").gg_txn_commit, keys.device,
                best.data_ptr(), keys.data_ptr(), _bytes(write),
                wval.data_ptr(), cur.data_ptr(), issue.data_ptr(),
                _bytes(active), _ptr(owner), _ptr(slot), _ptr(vals),
                _ptr(vers), _ptr(view), op_ver.data_ptr(), op_val.data_ptr(),
                commit_round.data_ptr(), issue_round.data_ptr(),
                req.data_ptr(), n, t_dim, o, k_dim,
                0 if vals is None else vals.shape[1], int(t), int(row0), nt)
    return req
