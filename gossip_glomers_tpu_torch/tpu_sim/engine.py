"""Round drivers: the port of gossip_glomers_tpu/tpu_sim/engine.py's loop
combinators (``fori_rounds``, ``while_converge``, ``stepwise_converge``)
as Python loops — PyTorch runs eagerly, so each round is a few kernel
launches and the loop itself stays on the host — of its windows-as-data
fault schedule fold (``windows_fold``), of its destination-slab
blocking (``scan_blocks``, ``resolve_block``), of its
:class:`Collectives` (``collectives``, off a mesh and on a
:class:`..parallel.mesh.Mesh` of any of its shapes), of its node-axis
helpers (:func:`node_axes`, :func:`node_shards`, and
:func:`node_index`), of its DCN modes (:class:`DcnMode`,
:func:`resolve_dcn_mode`, the staleness carry :class:`DcnRound`,
:func:`dcn_psum`), of its halo primitives (:func:`sharded_roll`,
:func:`sharded_shift`), of its scenario placement
(:func:`scenario_placement`) and of its analytic footprint formula
(``operand_bytes``, ``analytic_peak_bytes``).

On a mesh every shard is one process (one rank of the mesh's process
group) holding its block of the node axis (and on a ``words`` mesh of a
bitset's words); the halo primitives and the OR / AND / prefix circuits
are ppermutes of blocks and slices (:meth:`..parallel.mesh.Mesh.
ppermute`), never an all-gather of the operands.  On a hierarchical
``("hosts", "nodes")`` mesh they run within a host over ``nodes`` first
and then carry one per-host partial over ``hosts``, which ``dcn=``
schedules: synchronous, pipelined (two half-block exchanges in flight),
or stale by up to k rounds (an outbox carried round to round).  The carry's
layout is learned from the first round's operands, not from a probe
run, so a stale run makes the collectives of its rounds and no other."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..parallel.mesh import HOSTS_AXIS, NODES_AXIS, WORDS_AXIS, Mesh


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on CUDA unless the caller passes a
    device; with none given and no CUDA present they raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on a GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    return torch.device(device)


class Collectives(NamedTuple):
    """The cross-shard surface a sim round consumes:

    - ``row_ids``: (block,) int32 global node indices of the local rows;
    - ``widen(x)``: the local block to the full node axis (identity, or
      an all-gather along ``gather_axis``);
    - ``reduce_sum`` / ``max`` / ``min``: a reduction over the shards
      (identity, or an all-reduce; ``reduce_sum`` over every mesh axis,
      the extrema over the node axis);
    - ``reduce_or`` / ``reduce_and``: bitwise OR / AND over the shards,
      as the reference's recursive-doubling (a power-of-two mesh) or
      ring ppermute circuit of the per-shard partial — every backend runs
      it (NCCL has no bitwise all-reduce), so the CPU tests check the
      code that the card runs;
    - ``exclusive_sum``: the per-element sum over all lower shards
      (zeros on shard 0 and off-mesh), a Hillis-Steele ppermute scan;
    - ``local_cols(m)``: this shard's column block of a full (N, N)
      matrix;
    - ``axis_name``: the node axis (``"nodes"``, or ``("hosts",
      "nodes")`` on a hierarchical mesh), or None off-mesh."""

    row_ids: torch.Tensor
    widen: Callable[[torch.Tensor], torch.Tensor]
    reduce_sum: Callable[[torch.Tensor], torch.Tensor]
    reduce_max: Callable[[torch.Tensor], torch.Tensor]
    reduce_min: Callable[[torch.Tensor], torch.Tensor]
    reduce_or: Callable[[torch.Tensor], torch.Tensor]
    reduce_and: Callable[[torch.Tensor], torch.Tensor]
    exclusive_sum: Callable[[torch.Tensor], torch.Tensor]
    local_cols: Callable[[torch.Tensor], torch.Tensor]
    axis_name: str | None


def check_mesh(mesh) -> None:
    """A mesh must be the port's :class:`..parallel.mesh.Mesh` (None:
    off a mesh)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"a mesh of type {type(mesh).__name__}: the port "
                        "runs parallel.mesh.Mesh (pick_mesh, pick_mesh_2d "
                        "or make_mesh)")


def node_axes(mesh, axis: str = NODES_AXIS):
    """The axis name(s) the node dimension is sharded over: the mesh's
    own :attr:`..parallel.mesh.Mesh.node_axis` (``"nodes"`` on a 1-D or
    a ``(nodes, words)`` mesh, ``("hosts", "nodes")`` on a hierarchical
    mesh, hosts-major, the order the mesh linearizes); ``axis`` off a
    mesh."""
    check_mesh(mesh)
    if mesh is None:
        return axis
    na = mesh.node_axis
    return na if len(na) > 1 else na[0]


def node_shards(mesh, axis: str = "nodes") -> int:
    """The node-shard count of ``mesh`` (hosts x per host on a
    hierarchical mesh, the ``nodes`` extent on a words mesh), 1 off a
    mesh: what every blocked layout divides the node axis by."""
    check_mesh(mesh)
    return 1 if mesh is None else mesh.axis_size(node_axes(mesh, axis))


def node_index(mesh, axis: str = "nodes") -> int:
    """This rank's node-shard index (its rank on a 1-D or a hierarchical
    mesh, its ``nodes`` coordinate on a words mesh), 0 off a mesh."""
    check_mesh(mesh)
    return 0 if mesh is None else mesh.axis_index(node_axes(mesh, axis))


def word_shards(mesh) -> int:
    """The ``words`` extent of ``mesh`` (1 without that axis)."""
    check_mesh(mesh)
    if mesh is None or WORDS_AXIS not in mesh.axis_names:
        return 1
    return mesh.axis_size(WORDS_AXIS)


def word_index(mesh) -> int:
    """This rank's ``words`` coordinate (0 without that axis)."""
    if word_shards(mesh) == 1:
        return 0
    return mesh.axis_index(WORDS_AXIS)


def refuse_words(mesh, what: str) -> None:
    """``what`` runs on node meshes only: a ``words`` axis refuses (the
    sims other than the broadcast simulator shard no bitset words)."""
    if mesh is not None and WORDS_AXIS in mesh.axis_names:
        raise ValueError(f"{what} shards its rows over the node axis only; "
                         "a mesh with a 'words' axis is the broadcast "
                         "simulator's (BroadcastSim)")


def scenario_placement(n_scenarios: int, mesh=None,
                       axis: str = "nodes") -> str:
    """Where the scenario axis of a batch lives (:mod:`.scenario`):

    - ``"scenario"``: on a mesh where S is a multiple of the node-shard
      count and at least that count; each rank runs its contiguous block
      of S / R whole scenarios, with identity collectives (a scenario's
      node axis is never sharded), and the ranks' results are gathered
      once when the batch is collected;
    - ``"single"``: otherwise; every rank runs the whole batch, as the
      reference runs it undivided (a caller that wants scenario
      placement pads S up, ``scenario.pad_batch``)."""
    if mesh is None:
        return "single"
    k = node_shards(mesh, axis)
    return ("scenario" if n_scenarios >= k and n_scenarios % k == 0
            else "single")


def _check_shards(mesh, n_shards: int) -> None:
    if mesh is None or node_shards(mesh) != n_shards:
        raise ValueError(
            f"a halo closure built for {n_shards} shards runs on a mesh "
            f"of that many node shards, got {mesh!r}")


def sharded_roll(x_local: torch.Tensor, s: int, n: int, n_shards: int,
                 mesh) -> torch.Tensor:
    """Distributed ``torch.roll(x, s, dims=1)`` of a words-major (W, N)
    array block-sharded over ``mesh``'s node axis: a rotation by ``s``
    touches at most two source shards a destination shard, so it is one
    or two ppermutes of slices (B columns a shard in all) and a local
    stitch."""
    _check_shards(mesh, n_shards)
    block = x_local.shape[1]
    if block * n_shards != n:
        raise ValueError("node axis must shard evenly")
    s = s % n
    q, r = divmod(s, block)
    # out_local[:, c] = global[:, (p*B + c - s) mod N]:
    #   c in [r, B) -> cols [0, B-r) of block (p - q);
    #   c in [0, r) -> cols [B-r, B) of block (p - q - 1).

    def send(sl: torch.Tensor, off: int) -> torch.Tensor:
        if off % n_shards == 0:
            return sl
        perm = [((p - off) % n_shards, p) for p in range(n_shards)]
        return mesh.ppermute(sl, perm)

    if r == 0:
        return send(x_local, q)
    head = send(x_local[:, : block - r], q)        # dest cols [r, B)
    tail = send(x_local[:, block - r:], q + 1)     # dest cols [0, r)
    return torch.cat([tail, head], dim=1)


def sharded_shift(x_local: torch.Tensor, s: int, n_shards: int,
                  mesh) -> torch.Tensor:
    """Distributed zero-fill shift of a words-major (W, N) array
    block-sharded over ``mesh``'s node axis: out[:, g] = x[:, g + s] for
    0 <= g + s < N, else 0.  Only the |s|-column halo moves; the boundary
    shards take ppermute's zeros as the fill.  Requires |s| < block."""
    _check_shards(mesh, n_shards)
    block = x_local.shape[1]
    a = abs(s)
    if a >= block:
        raise ValueError("halo shift needs |s| < block; use sharded_roll")
    if a == 0:
        return x_local
    if s > 0:
        halo = mesh.ppermute(x_local[:, :a],
                             [(p + 1, p) for p in range(n_shards - 1)])
        return torch.cat([x_local[:, a:], halo], dim=1)
    halo = mesh.ppermute(x_local[:, block - a:],
                         [(p, p + 1) for p in range(n_shards - 1)])
    return torch.cat([halo, x_local[:, : block - a]], dim=1)


def _or_level(xs: list, mesh, k: int, axis) -> list:
    # OR all-reduce over ONE axis by ppermutes: recursive doubling on a
    # power-of-two axis (step d pairs shard p with p XOR d), a ring
    # otherwise; the operands in ``xs`` travel together, each its own
    # independent circuit
    if k & (k - 1) == 0:
        d = 1
        while d < k:
            got = mesh.ppermute_many(xs, [(p ^ d, p) for p in range(k)],
                                     axis)
            xs = [x | g for x, g in zip(xs, got)]
            d <<= 1
        return xs
    acc, cur = list(xs), list(xs)
    for _ in range(k - 1):
        cur = mesh.ppermute_many(cur, [((p + 1) % k, p) for p in range(k)],
                                 axis)
        acc = [a | c for a, c in zip(acc, cur)]
    return acc


def _excl_level(xs: list, mesh, k: int, axis) -> list:
    # Hillis-Steele inclusive scan over ONE axis (shards below the
    # stride receive ppermute's zeros), minus the local term
    acc, d = list(xs), 1
    while d < k:
        got = mesh.ppermute_many(acc, [(p, p + d) for p in range(k - d)],
                                 axis)
        acc = [a + g for a, g in zip(acc, got)]
        d <<= 1
    return [a - x for a, x in zip(acc, xs)]


def _sum_level(xs: list, mesh, k: int, axis) -> list:
    del k
    return mesh.all_reduce_many(xs, "sum", axis)


# -- the DCN modes of the hosts level -----------------------------------


class DcnMode(NamedTuple):
    """How the hosts level of the two-level circuits carries its one
    per-host partial (the reference's ``DcnMode``):

    - ``pipeline``: the partial travels as two half-block exchanges in
      flight at once (two ``async_op`` works, or one batch of tagged
      sends, waited on together).  The halves combine to the same value,
      so every integer and bool reduction is bit-exact with the
      synchronous twin; floating operands keep the fused all-reduce.
    - ``stale_k``: ``reduce_sum`` / ``reduce_or`` / ``reduce_and``
      consumers may lag up to k rounds behind the other hosts.  Each
      shard accumulates its per-round operand into an outbox slot of the
      round loop's carry (:class:`DcnRound`) and only every k-th round pays
      the hosts exchange, which delivers the whole backlog (each delta
      counted once; k = 1 is the synchronous twin).  ``exclusive_sum``,
      ``reduce_min`` / ``reduce_max`` and ``widen`` refuse under
      staleness.

    Both compose: ``pipelined+stale:k``.  Off by default
    (:data:`DCN_SYNC`)."""

    pipeline: bool = False
    stale_k: int = 0

    def label(self) -> str:
        """The canonical mode string (:func:`resolve_dcn_mode`'s
        grammar), which the nemesis runners record in ``runner_kw`` so
        that a flight bundle replays the mode."""
        parts = []
        if self.pipeline:
            parts.append("pipelined")
        if self.stale_k:
            parts.append(f"stale:{self.stale_k}")
        return "+".join(parts) if parts else "sync"


#: the synchronous default: one fused exchange a reduction, no lag
DCN_SYNC = DcnMode()


def dcn_mode_from_env() -> DcnMode:
    """The env's :class:`DcnMode`: ``GG_DCN_PIPELINE`` (0 / 1) and
    ``GG_DCN_STALE_K`` (rounds of lag), parsed loudly (:func:`_env_int`):
    a non-integer raises naming the variable, an out-of-range value
    refuses.  Synchronous by default."""
    pipe = _env_int("GG_DCN_PIPELINE",
                    os.environ.get("GG_DCN_PIPELINE", "0"))
    if pipe not in (0, 1):
        raise ValueError(f"GG_DCN_PIPELINE={pipe} must be 0 or 1")
    k = _env_int("GG_DCN_STALE_K", os.environ.get("GG_DCN_STALE_K", "0"))
    if k < 0:
        raise ValueError(f"GG_DCN_STALE_K={k} must be >= 0")
    return DcnMode(pipeline=bool(pipe), stale_k=k)


def resolve_dcn_mode(setting=None) -> DcnMode:
    """A sim's ``dcn_mode`` argument: None defers to the env
    (:func:`dcn_mode_from_env`), a :class:`DcnMode` passes, a string is
    parsed from ``"sync" | "pipelined" | "stale:<k>" |
    "pipelined+stale:<k>"``; anything else refuses."""
    if setting is None:
        return dcn_mode_from_env()
    if isinstance(setting, DcnMode):
        if setting.stale_k < 0:
            raise ValueError(
                f"dcn_mode stale_k={setting.stale_k} must be >= 0")
        return setting
    if isinstance(setting, str):
        pipeline, stale_k = False, 0
        for part in setting.split("+"):
            if part == "sync":
                continue
            if part == "pipelined":
                pipeline = True
            elif part.startswith("stale:"):
                stale_k = _env_int(f"dcn_mode {setting!r}", part[6:])
                if stale_k < 0:
                    raise ValueError(
                        f"dcn_mode {setting!r}: stale k must be >= 0")
            else:
                raise ValueError(
                    f"dcn_mode {setting!r}: unknown part {part!r} "
                    "(expected 'sync', 'pipelined', 'stale:<k>', or "
                    "'pipelined+stale:<k>')")
        return DcnMode(pipeline=pipeline, stale_k=stale_k)
    raise ValueError(
        "dcn_mode must be None, a DcnMode, or a mode string — got "
        f"{type(setting).__name__}")


class DcnRound:
    """One round's bounded-staleness context, which a ``stale_k`` round loop
    hands :func:`collectives` (``dcn=``): the round's ``age`` (a host
    int; age % k == 0 pays the hosts exchange, so age 0 refreshes) and
    the carried outbox slots, one a stale member call in call order.

    The loop keeps ``(age + 1, ctx.carry_out())`` for the next round
    and resets it to ``(0, None)`` with a fresh state.  ``carry=None``
    is a carry whose layout is not known yet: each member's slot starts
    as zeros shaped like its first operand, so the first round learns
    the layout without the reference's probe run (``eval_shape``, which
    eager PyTorch has no counterpart of): no extra collective, no change
    to the state or the ledgers."""

    def __init__(self, mode, *, age: int | None = None,
                 carry=None) -> None:
        self.mode = resolve_dcn_mode(mode)
        self.age = age
        self._learn = carry is None
        self._carry_in = () if carry is None else tuple(carry)
        self._take_i = 0
        self._out = []
        self.refresh = True
        if self.mode.stale_k:
            if age is None:
                raise ValueError(
                    "DcnRound needs the carried round age (a host int) "
                    "to derive the refresh cadence")
            self.refresh = age % self.mode.stale_k == 0

    def _take(self, like: torch.Tensor) -> torch.Tensor:
        """The next slot, shaped like ``like``."""
        if self._learn and self._take_i >= len(self._carry_in):
            self._carry_in += (torch.zeros_like(like),)
        if self._take_i >= len(self._carry_in):
            raise ValueError(
                f"DCN staleness carry exhausted: round consumed slot "
                f"{self._take_i} but the carry holds "
                f"{len(self._carry_in)} — the round's collective "
                "structure changed")
        x = self._carry_in[self._take_i]
        self._take_i += 1
        return x

    def _put(self, v: torch.Tensor) -> None:
        self._out.append(v)

    def carry_out(self) -> tuple:
        """The updated slots in take order: the next round's carry."""
        if self._take_i != len(self._carry_in) or \
                len(self._out) != len(self._carry_in):
            raise ValueError(
                f"DCN staleness carry mismatch: {self._take_i} taken / "
                f"{len(self._out)} updated vs {len(self._carry_in)} "
                "carried — the round's collective structure changed")
        return tuple(self._out)


def _dcn_chunks(x: torch.Tensor):
    """The two half-blocks of a per-host partial (the double buffer) and
    the join back, or None for an operand too small to split."""
    if x.dim() == 0 or x.numel() < 2:
        return None
    flat = x.reshape(-1)
    h = flat.shape[0] // 2

    def join(ys, shape=x.shape):
        return torch.cat(ys).reshape(shape)

    return (flat[:h], flat[h:]), join


def _dcn_pipelineable(x: torch.Tensor) -> bool:
    # only integer and bool operands may split the fused all-reduce:
    # floating reassociation would drift from the synchronous twin
    return not (x.is_floating_point() or x.is_complex())


def _dcn_level(x: torch.Tensor, level, mesh, k: int, *,
               pipeline: bool) -> torch.Tensor:
    # the hosts-level exchange of one per-host partial: one circuit in
    # sync mode; in pipelined mode two independent half-block circuits
    # whose transfers are in flight together
    if pipeline:
        split = _dcn_chunks(x)
        if split is not None:
            parts, join = split
            return join(level(list(parts), mesh, k, HOSTS_AXIS))
    return level([x], mesh, k, HOSTS_AXIS)[0]


def _resolve_dcn(dcn):
    if isinstance(dcn, DcnRound):
        return dcn.mode, dcn
    if isinstance(dcn, DcnMode):
        return dcn, None
    if dcn is None:
        return DCN_SYNC, None
    raise ValueError(
        "collectives dcn= must be None, a DcnMode, or a DcnRound "
        f"— got {type(dcn).__name__}")


def collectives(block: int, mesh=None, *,
                device: str | torch.device | None = None,
                axis: str = "nodes", gather_axis: int = 0,
                dcn=None) -> Collectives:
    """The :class:`Collectives` of a round over ``block`` local rows: off
    a mesh on one device (:func:`resolve_device`: CUDA unless the caller
    passes one), on a mesh over its node shards (the blocks on
    ``mesh.device``).  ``reduce_sum`` reduces over every axis of the
    mesh; the other members over the node axis.

    On a hierarchical mesh the exchange members run two-level circuits:
    the ppermute ladder over ``nodes`` within a host first, then the same
    ladder over ``hosts`` carrying one per-host partial; ``exclusive_sum``
    is the intra-host scan plus the hosts-level scan of the per-host
    sums.  Row ids, gathers and column slices compose the two indices
    hosts-major, so they are the flat mesh's.

    ``dcn`` (:class:`DcnMode`, :class:`DcnRound`, or None for
    :data:`DCN_SYNC`) schedules the hosts level: ``pipeline`` splits the
    per-host partial into two half-blocks in flight together (the value
    unchanged); a ``stale_k`` mode needs the round loop's :class:`DcnRound`
    carry and a hierarchical mesh, and gives ``reduce_sum`` the
    accumulating outbox (lag rounds serve zero), ``reduce_or`` the
    accumulating OR and ``reduce_and`` the last refresh's snapshot met
    with the current intra-host partial; the other members refuse."""
    if mesh is None:
        def ident(x):
            return x

        return Collectives(
            row_ids=torch.arange(block, dtype=torch.int32,
                                 device=resolve_device(device)),
            widen=ident, reduce_sum=ident, reduce_max=ident,
            reduce_min=ident, reduce_or=ident, reduce_and=ident,
            exclusive_sum=torch.zeros_like, local_cols=ident,
            axis_name=None)
    check_mesh(mesh)
    mode, ctx = _resolve_dcn(dcn)
    na = node_axes(mesh, axis)
    hier = na != axis
    n_inner = mesh.axis_size(axis) if axis in mesh.axis_names else 1
    n_hosts = mesh.axis_size(HOSTS_AXIS) if hier else 1
    if mode.stale_k:
        if not hier:
            raise ValueError(
                f"stale_k={mode.stale_k} needs a hierarchical "
                "(hosts x nodes) mesh: a flat mesh has no DCN level "
                "to lag — refuse instead of silently running sync")
        if ctx is None:
            raise ValueError(
                f"stale_k={mode.stale_k} reached collectives() as a "
                "bare DcnMode: this driver does not thread the DCN "
                "staleness carry (DcnRound) — refuse instead of "
                "silently running the synchronous circuit")
    pipeline = mode.pipeline and hier
    stale = bool(mode.stale_k) and hier
    all_axes = tuple(mesh.axis_names)
    p = node_index(mesh, axis)
    row_ids = p * block + torch.arange(block, dtype=torch.int32,
                                       device=mesh.device)

    def or_inner(x):
        # the intra-host ladder: everything below the hosts hop
        return (_or_level([x], mesh, n_inner, axis)[0] if n_inner > 1
                else x)

    def or_hosts(part):
        return _dcn_level(part, _or_level, mesh, n_hosts,
                          pipeline=pipeline)

    def reduce_or(x):
        part = or_inner(x)
        if n_hosts < 2:
            return part
        if not stale:
            return or_hosts(part)
        # the accumulating outbox: the slot ORs up this shard's
        # operands; the intra-host ladder runs every round and every
        # k-th round the hosts exchange unions the backlog (idempotent:
        # no bit lags more than k - 1 rounds), then clears the outbox
        acc = ctx._take(x) | x
        if ctx.refresh:
            ctx._put(torch.zeros_like(acc))
            return or_hosts(or_inner(acc))
        ctx._put(acc)
        return part

    def reduce_and(x):
        if not stale:
            return ~reduce_or(~x)
        # the snapshot: the slot holds the last refresh's global AND;
        # a lag round serves its meet with the current intra-host
        # partial (the monotone visibility predicates under-report)
        part = ~or_inner(~x)
        slot = ctx._take(part)
        if ctx.refresh:
            glob = ~or_hosts(~part)
            ctx._put(glob)
            return glob
        ctx._put(slot)
        return part & slot

    def sum_all(x):
        # the sum over every axis, the hosts level split out (and
        # half-blocked) in pipelined mode for integer operands; floats
        # keep the fused all-reduce
        if not pipeline or not _dcn_pipelineable(x):
            return mesh.all_reduce(x, "sum", all_axes)
        inner = tuple(a for a in all_axes if a != HOSTS_AXIS)
        part = mesh.all_reduce(x, "sum", inner) if n_inner > 1 else x
        return _dcn_level(part, _sum_level, mesh, n_hosts, pipeline=True)

    def reduce_sum(x):
        if not stale:
            return sum_all(x)
        if not _dcn_pipelineable(x):
            raise ValueError(
                "stale_k reduce_sum on a floating operand refuses: "
                "deferred delivery has no bit-exactness story for "
                "floats (integer and bool deltas only)")
        # deferred delivery: the slot accumulates this shard's operands;
        # a lag round serves zero (a replicated constant), a refresh
        # round delivers the global backlog in one sum; each delta is
        # counted once and lags fewer than k rounds
        acc = ctx._take(x) + x
        if ctx.refresh:
            ctx._put(torch.zeros_like(acc))
            return sum_all(acc)
        ctx._put(acc)
        return torch.zeros_like(acc)

    def stale_refusal(member: str, why: str):
        def refuse(x):
            raise ValueError(
                f"{member} has no certified staleness semantics "
                f"({why}) — stale_k engine mode refuses; run sync or "
                "pipelined")
        return refuse

    if stale:
        reduce_max = stale_refusal(
            "reduce_max", "extremum folds must see every shard")
        reduce_min = stale_refusal(
            "reduce_min", "CAS winner folds must see every shard")
        widen = stale_refusal("widen", "operand delivery must be exact")
        exclusive_sum = stale_refusal(
            "exclusive_sum", "global rank/offset allocation must be exact")
    else:
        def extremum(op):
            if not pipeline:
                return lambda x: mesh.all_reduce(x, op, na)

            # per level: exact for every dtype, and the hosts level
            # again carries one per-host partial
            def fold(x):
                part = (mesh.all_reduce(x, op, axis) if n_inner > 1
                        else x)
                return mesh.all_reduce(part, op, HOSTS_AXIS)
            return fold

        reduce_max, reduce_min = extremum("max"), extremum("min")

        def widen(x):
            return mesh.all_gather(x, dim=gather_axis, axis=na)

        def exclusive_sum(x):
            # shard (h, i): the intra-host exclusive scan, plus over the
            # hosts the exclusive scan of each host's whole partial (one
            # summed block a host crosses the hosts level)
            out = (_excl_level([x], mesh, n_inner, axis)[0] if n_inner > 1
                   else torch.zeros_like(x))
            if n_hosts > 1:
                host = (mesh.all_reduce(x, "sum", axis) if n_inner > 1
                        else x)
                out = out + _dcn_level(
                    host, _excl_level, mesh, n_hosts,
                    pipeline=pipeline and _dcn_pipelineable(x))
            return out

    return Collectives(
        row_ids=row_ids,
        widen=widen,
        reduce_sum=reduce_sum,
        reduce_max=reduce_max,
        reduce_min=reduce_min,
        reduce_or=reduce_or,
        reduce_and=reduce_and,
        exclusive_sum=exclusive_sum,
        local_cols=lambda m: m[:, p * block:(p + 1) * block],
        axis_name=na)


def dcn_psum(mesh, mode=None, *, axis: str = "nodes") -> Callable:
    """The mode-aware sum over every axis of ``mesh`` for the sites that
    take a bare sum closure rather than :class:`Collectives` (the
    broadcast simulator's ledgers): the same value, the hosts level
    split into two half-block all-reduces in pipelined mode (integer and
    bool operands; floats keep the fused one).  A ``stale_k`` mode
    refuses: these sites feed delivery and ledger calibration, whose
    staleness semantics are undecided.  The identity off a mesh."""
    mode = resolve_dcn_mode(mode)
    if mode.stale_k:
        raise ValueError(
            f"dcn_psum: dcn_mode {mode.label()!r} refuses — delivery and "
            "ledger sums have no certified staleness semantics")
    if mesh is None:
        return lambda x: x
    return collectives(1, mesh, axis=axis,
                       dcn=DcnMode(pipeline=mode.pipeline)).reduce_sum


def local_block(x, spec, mesh, *, dtype: torch.dtype | None = None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """A rank's part of a whole cluster's leaf ``x`` (numpy or a tensor)
    by its shard spec (the reference's ``PartitionSpec`` entries as a
    tuple): the rank's block of the first axis where the spec names the
    ``nodes`` axis there, else the whole leaf; the whole leaf off a mesh.
    A contiguous tensor of ``dtype`` on ``device``."""
    if mesh is not None and spec and spec[0] == "nodes":
        n, k = x.shape[0], node_shards(mesh)
        if n % k:
            raise ValueError(f"node axis {n} does not shard evenly over "
                             f"{k} ranks")
        b = n // k
        x = x[node_index(mesh) * b:(node_index(mesh) + 1) * b]
    t = (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.array(x, copy=True)))
    return t.to(device=device, dtype=dtype).contiguous()


def fori_rounds(round_fn: Callable, state, rounds: int):
    """Exactly ``rounds`` rounds — the fixed-trip driver."""
    for _ in range(rounds):
        state = round_fn(state)
    return state


def while_converge(round_fn: Callable, converged: Callable, state,
                   limit: int):
    """Run to convergence: tests ``converged`` BEFORE the first round (an
    already converged state runs no round) and after each one, and stops
    once ``state.t`` reaches ``limit``."""
    done = converged(state)
    while not done and state.t < limit:
        state = round_fn(state)
        done = converged(state)
    return state


def stepwise_converge(step: Callable, converged: Callable, state,
                      max_rounds: int, check_every: int = 1):
    """The host-driven convergence loop: always runs at least one batch
    of ``check_every`` rounds, then checks.  Returns (final state,
    rounds run)."""
    rounds = 0
    while rounds < max_rounds:
        for _ in range(check_every):
            state = step(state)
            rounds += 1
        if converged(state):
            break
    return state, rounds


def send_slot(t: int, delay: int, ring: int) -> int | None:
    """The slot of an L = ``ring`` payload ring that an edge of ``delay``
    rounds reads at round ``t``: that of its send round ``t - (delay -
    1)``, or None before round ``delay - 1`` (nothing was in flight
    yet)."""
    src_t = t - (delay - 1)
    return None if src_t < 0 else src_t % ring


def active_windows(starts: Sequence[int], ends: Sequence[int],
                   t: int) -> list[int]:
    """The windows ``w`` with ``starts[w] <= t < ends[w]``."""
    return [w for w, (lo, hi) in enumerate(zip(starts, ends))
            if lo <= t < hi]


def windows_fold(starts: Sequence[int], ends: Sequence[int], t: int,
                 body: Callable, init):
    """Fold a windows-as-data fault schedule at round ``t``: ``carry =
    body(w, carry)`` for every window active at ``t``, in window order.
    The reference folds every window with a traced ``active`` flag
    (``body(w, active, carry)``); here ``t`` is a host int, so the active
    set is computed on the host and an inactive window costs nothing.
    No active window returns ``init`` itself."""
    carry = init
    for w in active_windows(starts, ends, t):
        carry = body(w, carry)
    return carry


def scan_blocks(body: Callable, carry, axis_len: int, block: int):
    """Destination-axis blocking: ``carry = body(carry, lo)`` for slab
    starts ``lo = 0, block, 2*block, ...`` — the reference's ``lax.scan``
    over slabs as a Python loop.  ``block`` must divide ``axis_len`` (use
    :func:`resolve_block`)."""
    if axis_len % block != 0:
        raise ValueError(
            f"block {block} must divide the destination axis "
            f"{axis_len}")
    for lo in range(0, axis_len, block):
        carry = body(carry, lo)
    return carry


def _divisors(n: int) -> list:
    out = set()
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.add(d)
            out.add(n // d)
        d += 1
    return sorted(out)


def _env_int(name: str, raw: str) -> int:
    """Parse an integer env-var value with an error naming the
    variable."""
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer (nor a recognized "
            "keyword)") from None


def resolve_block(rows: int, setting=None, *, per_row_bytes: int = 1,
                  budget_bytes: int | None = None) -> int | None:
    """Destination-slab size for :func:`scan_blocks`, or None for the
    materialized whole-axis round (the reference's rules and messages).

    ``setting`` (a sim's ``union_block``; None defers to the
    ``GG_UNION_BLOCK`` env, default ``"auto"``):

    - ``"materialized"`` -> None;
    - an int -> that slab size, clamped to the largest divisor of
      ``rows`` not above it; <= 0 means materialized;
    - ``"auto"`` -> materialized while ``rows * per_row_bytes`` fits
      ``budget_bytes`` (default ``GG_UNION_BLOCK_BUDGET_MB``, 512 MB),
      else the largest divisor of ``rows`` whose slab fits.

    Env values are parsed loudly: one that is neither keyword nor an
    integer, an integer that does not divide ``rows``, or a negative
    budget raises a ``ValueError`` naming the variable."""
    env_src = None
    if setting is None:
        env_src = "GG_UNION_BLOCK"
        setting = os.environ.get(env_src, "auto")
    if setting == "materialized":
        return None
    if setting == "auto":
        if budget_bytes is None:
            name = "GG_UNION_BLOCK_BUDGET_MB"
            mb = _env_int(name, os.environ.get(name, "512"))
            if mb < 0:
                raise ValueError(
                    f"{name}={mb} must be a non-negative slab budget "
                    "in MB")
            budget_bytes = mb * 1_000_000
        if rows * per_row_bytes <= budget_bytes:
            return None
        return max((d for d in _divisors(rows)
                    if d * per_row_bytes <= budget_bytes), default=1)
    if env_src is not None:
        b = _env_int(env_src, setting)
        if 0 < b < rows and rows % b != 0:
            near = [d for d in _divisors(rows) if d <= b]
            raise ValueError(
                f"{env_src}={b} does not divide the {rows}-row "
                f"destination axis (scan_blocks needs even slabs); "
                f"use a divisor (e.g. {near[-1] if near else 1}), "
                f"'auto', or 'materialized'")
    else:
        try:
            b = int(setting)
        except (TypeError, ValueError):
            raise ValueError(
                f"union_block setting {setting!r} is not 'auto', "
                "'materialized', or an integer") from None
    if b <= 0:
        return None
    if b >= rows:
        return rows
    return max(d for d in _divisors(rows) if d <= b)


def operand_bytes(tree) -> int:
    """Total bytes of an operand tree (a :class:`.faults.FaultPlan`, a
    KVReach schedule, staged batches): tensors and numpy arrays by their
    size, host ints as the reference's int32 / uint32 scalars (4 bytes
    each, also inside tuples), dataclasses, named tuples, lists and
    dicts by their members.  The operand term of
    :func:`analytic_peak_bytes`; a FaultPlan counts as the reference's
    ten leaves."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "nbytes") and hasattr(tree, "dtype"):
        return int(tree.nbytes)
    if isinstance(tree, (bool, int)):
        return 4
    if dataclasses.is_dataclass(tree):
        return sum(operand_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(operand_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(operand_bytes(v) for v in tree)
    raise TypeError(f"no operand size for {type(tree).__name__}")


def analytic_peak_bytes(*, state_bytes: int, operand_bytes: int = 0,
                        slab_bytes: int = 0,
                        donated: bool = True) -> dict:
    """The reference's analytic peak-live-bytes formula:

        peak = state x (1 donated / 2 not) + operands (plan leaves,
               staged batches, never donated) + transient slab temps

    (the blocked coin slab, or the whole materialized mask)."""
    state_term = state_bytes * (1 if donated else 2)
    return {"state_bytes": state_bytes,
            "operand_bytes": operand_bytes,
            "slab_bytes": slab_bytes,
            "donated": donated,
            "peak_live_bytes": state_term + operand_bytes + slab_bytes}


def host_unpack_bits(words, n_bits: int | None = None):
    """Numpy unpacking of a packed bitset's last axis: ``(..., W)`` uint32
    words to ``(..., 32 W)`` bool, bit ``b`` of word ``w`` at column ``32 w
    + b`` (the reference's ``engine.host_unpack_bits``); ``n_bits`` cuts
    the tail off."""
    import numpy as np

    w = np.asarray(words, np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((w[..., None] >> shifts) & np.uint32(1)).astype(bool)
    out = bits.reshape(*w.shape[:-1], w.shape[-1] * 32)
    return out if n_bits is None else out[..., :n_bits]
