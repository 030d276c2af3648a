"""Round drivers: the port of gossip_glomers_tpu/tpu_sim/engine.py's loop
combinators (``fori_rounds``, ``while_converge``, ``stepwise_converge``)
as Python loops — PyTorch runs eagerly, so each round is a few kernel
launches and the loop itself stays on the host — of its windows-as-data
fault schedule fold (``windows_fold``), of its destination-slab
blocking (``scan_blocks``, ``resolve_block``), of its
:class:`Collectives` (``collectives``, off a mesh and on a 1-D
:class:`..parallel.mesh.Mesh`), of its halo primitives
(:func:`sharded_roll`, :func:`sharded_shift`), of its scenario
placement (:func:`scenario_placement`) and of its analytic footprint
formula (``operand_bytes``, ``analytic_peak_bytes``).

On a mesh every shard is one process (one rank of the mesh's process
group) holding its block of the node axis; the halo primitives and the
OR / AND / prefix circuits are ppermutes of blocks and slices
(:meth:`..parallel.mesh.Mesh.ppermute`), never an all-gather of the
operands.  The DCN modes (``dcn=``) and the hierarchical mesh are
ROADMAP.md Queue A item 10."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch


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
      (identity, or an all-reduce);
    - ``reduce_or`` / ``reduce_and``: bitwise OR / AND over the shards,
      as the reference's recursive-doubling (a power-of-two mesh) or
      ring ppermute circuit of the per-shard partial — every backend runs
      it (NCCL has no bitwise all-reduce), so the CPU tests check the
      code that the card runs;
    - ``exclusive_sum``: the per-element sum over all lower shards
      (zeros on shard 0 and off-mesh), a Hillis-Steele ppermute scan;
    - ``local_cols(m)``: this shard's column block of a full (N, N)
      matrix;
    - ``axis_name``: ``"nodes"``, or None off-mesh."""

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


#: the reserved DCN axis name of the reference's hierarchical mesh
HOSTS_AXIS = "hosts"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               "(ROADMAP.md Queue A item 10)")


def _check_flat(mesh) -> None:
    """A mesh must be the port's 1-D :class:`..parallel.mesh.Mesh`; any
    other (a JAX mesh, a hierarchical or words mesh) is not ported."""
    from ..parallel.mesh import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise _unported(f"a mesh of type {type(mesh).__name__} (the port "
                        "runs parallel.mesh.Mesh, a 1-D nodes axis)")


def node_axes(mesh, axis: str = "nodes"):
    """The axis name the node dimension is sharded over: ``axis`` (a
    hierarchical mesh raises)."""
    _check_flat(mesh)
    return axis


def node_shards(mesh, axis: str = "nodes") -> int:
    """The node-shard count of ``mesh``, 1 off-mesh."""
    _check_flat(mesh)
    return 1 if mesh is None else int(mesh.size)


def scenario_placement(n_scenarios: int, mesh=None,
                       axis: str = "nodes") -> str:
    """Where the scenario axis of a batch lives (:mod:`.scenario`):

    - ``"scenario"``: on a mesh where S is a multiple of the rank count
      and at least that count; each rank runs its contiguous block of
      S / R whole scenarios, with identity collectives (a scenario's
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
    if mesh is None or mesh.size != n_shards:
        raise ValueError(
            f"a halo closure built for {n_shards} shards runs on a mesh "
            f"of that many ranks, got {mesh!r}")


def sharded_roll(x_local: torch.Tensor, s: int, n: int, n_shards: int,
                 mesh) -> torch.Tensor:
    """Distributed ``torch.roll(x, s, dims=1)`` of a words-major (W, N)
    array block-sharded over ``mesh``: a rotation by ``s`` touches at most
    two source shards a destination shard, so it is one or two ppermutes
    of slices (B columns a shard in all) and a local stitch."""
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
    block-sharded over ``mesh``: out[:, g] = x[:, g + s] for 0 <= g + s <
    N, else 0.  Only the |s|-column halo moves; the boundary shards take
    ppermute's zeros as the fill.  Requires |s| < block."""
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


def _or_level(x: torch.Tensor, mesh, k: int) -> torch.Tensor:
    # OR all-reduce by ppermutes: recursive doubling on a power-of-two
    # mesh (step d pairs shard p with p XOR d), a ring otherwise
    if k & (k - 1) == 0:
        d = 1
        while d < k:
            x = x | mesh.ppermute(x, [(p ^ d, p) for p in range(k)])
            d <<= 1
        return x
    acc, cur = x, x
    for _ in range(k - 1):
        cur = mesh.ppermute(cur, [((p + 1) % k, p) for p in range(k)])
        acc = acc | cur
    return acc


def _excl_level(x: torch.Tensor, mesh, k: int) -> torch.Tensor:
    # Hillis-Steele inclusive scan (shards below the stride receive
    # ppermute's zeros), minus the local term
    acc, d = x, 1
    while d < k:
        acc = acc + mesh.ppermute(acc, [(p, p + d) for p in range(k - d)])
        d <<= 1
    return acc - x


def collectives(block: int, mesh=None, *,
                device: str | torch.device | None = None,
                axis: str = "nodes", gather_axis: int = 0,
                dcn=None) -> Collectives:
    """The :class:`Collectives` of a round over ``block`` local rows: off
    a mesh on one device (:func:`resolve_device`: CUDA unless the caller
    passes one), on a 1-D mesh over its ranks (the blocks on
    ``mesh.device``).  ``dcn=`` modes and a hierarchical mesh raise
    (ROADMAP.md Queue A item 10)."""
    if dcn is not None:
        raise _unported("collectives(dcn=...)")
    if axis != "nodes":
        raise _unported(f"a mesh axis {axis!r}")
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
    _check_flat(mesh)
    k, p = mesh.size, mesh.rank
    row_ids = p * block + torch.arange(block, dtype=torch.int32,
                                       device=mesh.device)

    def reduce_or(x):
        return _or_level(x, mesh, k) if k > 1 else x

    return Collectives(
        row_ids=row_ids,
        widen=lambda x: mesh.all_gather(x, dim=gather_axis),
        reduce_sum=lambda x: mesh.all_reduce(x, "sum"),
        reduce_max=lambda x: mesh.all_reduce(x, "max"),
        reduce_min=lambda x: mesh.all_reduce(x, "min"),
        reduce_or=reduce_or,
        reduce_and=lambda x: ~reduce_or(~x),
        exclusive_sum=lambda x: _excl_level(x, mesh, k),
        local_cols=lambda m: m[:, p * block:(p + 1) * block],
        axis_name="nodes")


def local_block(x, spec, mesh, *, dtype: torch.dtype | None = None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """A rank's part of a whole cluster's leaf ``x`` (numpy or a tensor)
    by its shard spec (the reference's ``PartitionSpec`` entries as a
    tuple): the rank's block of the first axis where the spec names the
    ``nodes`` axis there, else the whole leaf; the whole leaf off a mesh.
    A contiguous tensor of ``dtype`` on ``device``."""
    if mesh is not None and spec and spec[0] == "nodes":
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"node axis {n} does not shard evenly over "
                             f"{mesh.size} ranks")
        b = n // mesh.size
        x = x[mesh.rank * b:(mesh.rank + 1) * b]
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
