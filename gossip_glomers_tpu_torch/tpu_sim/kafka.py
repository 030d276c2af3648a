"""The replicated append-only log (Gossip Glomers challenge 5, "Kafka") on
PyTorch: the port of gossip_glomers_tpu/tpu_sim/kafka.py's single-device
``KafkaSim``.

Semantics (the reference node's kafka/log.go and logmap.go): ``send``
allocates the key's next offset from a linearizable KV cell by a CAS loop,
appends locally and replicates fire-and-forget to every peer; ``poll``
serves the LOCAL log; ``commit_offsets`` runs the read / write / CAS dance
on the SAME cell the allocator uses, skipping keys whose local high-water
mark covers the request; ``list_committed_offsets`` serves the local
cache.  A round linearizes its sends in (node, slot) order (rank within
key, :func:`_rank_within_key`), and its commits read the cell after the
sends: the first CAS committer in node order wins, the last create-writer
lands.

State: ``log_vals`` (K, C) int32 content by (key, slot); ``present`` (N,
K, Wc) int32 words holding the reference's uint32 presence bits (bit c %
32 of word c // 32: node n holds slot c of key k); ``kv_val`` (K,) the
cells; ``local_committed`` (N, K) the committed-offset cache;
``origin_bits`` (N, K, Wc) the bits each node originated (``resync_mode=
"push"``; (N, K, 0) otherwise); ``t`` a host int; ``msgs`` a 0-dim int64
holding the reference's uint32 ledger; ``rows`` the device KV's rows
(``kv_backend="device"``) or None.

Replication, by ``_repl_mode``: ``union`` (every link delivers: one union
row of the round's new bits), ``union_nem`` (a crash / loss plan: each
destination row's faulted origin union, over all rows at once or in
``union_block`` slabs) and ``matmul`` (an explicit link mask, or
``repl_fast=False``: the byte-split masked OR as a matrix product, the
bit-exactness oracle).  A round is the allocation's O(N S) PyTorch ops,
then :func:`.kernels.kafka_merge` (and before it
:func:`.kernels.kafka_nem_deliver` under a plan, or the product), on a
round with commits or a resync :func:`.kernels.kafka_commit_select`, and
with commits :func:`.kernels.kafka_commit_apply`; no round reads
anything back to the host.  The kernels update ``present`` and ``local_committed`` in place:
:meth:`KafkaSim.run_fused` on the tensors of the state it is given,
:meth:`KafkaSim.step` and :meth:`KafkaSim.run_rounds` on copies made once.

The open-loop traffic driver (:meth:`KafkaSim.run_traffic`, with its
telemetry ring) stages the seeded client sends of a
:class:`.traffic.TrafficSpec` through the send path each round and tracks
each acked op until its (key, slot) bit is present at every node
(:func:`.kernels.and_fold` over the presence).  The observed driver
(:meth:`KafkaSim.run_observed`) records the telemetry ring and the
provenance stamps (:mod:`.provenance`: each slot's allocation round and
origin, from the round's own allocator, and its first presence at the
witness node) beside the staged rounds.

On a mesh (``KafkaSim(mesh=)``, a :class:`..parallel.mesh.Mesh`) each
rank holds its block of ``present``, ``local_committed``,
``origin_bits`` and the device KV's rows; ``log_vals`` and ``kv_val`` are
replicated, the row ids global.  The drivers take the full (N, S) and
(N, K) operands and each rank cuts its block.  A round allocates its
block's sends at their global rank (the local rank plus the
:func:`.engine.collectives` ``exclusive_sum`` of the lower ranks'
per-key counts), sums the written cells, the per-key counts and the send
ledger in one all-reduce, and replicates by mode: ``union`` ORs the
ranks' partial rows by ``reduce_or`` (no all-gather); materialized
``union_nem`` widens only the sends' packed (2, N S) metadata (one
all-gather) and runs :func:`.kernels.kafka_nem_deliver` over the rank's
rows against all N origins; blocked ``union_nem`` (an integer
``union_block``) passes the metadata block round a ring of ppermutes,
each step ORing the visiting origins' bits into the rank's slabs (no
all-gather); ``matmul`` gathers the ranks' own words (one all-gather)
and multiplies its columns of the link mask.  The resync union is the
merge's partial then ``reduce_or``; the commit winners are the
all-reduced minimum CAS row and maximum writer row, the new cells the
sum of the apply pass's partials (the block forms of the commit
kernels).  ``step``, ``run_rounds``, ``run_fused`` and the reads
(``present_bool``, ``poll``, ``poll_batch``, ``list_committed``,
``lin_kv``, ``alloc_offsets``) are collective calls: every rank makes
them, in the same order, and gets the same answer.  The traffic driver
and the observed driver's telemetry ring run there too: a rank stages its
own clients' sends (their home nodes lie in its block), evaluates the
round's allocation once (its ``exclusive_sum`` included) and hands it to
the round; an op is visible once :func:`.kernels.and_fold` over the
rank's presence rows, then ``reduce_and`` over the ranks, holds its bit;
the ring's partial columns (the witness row 0's popcount, which rank 0
holds and the others add 0 to, and the full presence popcount) and the
tracker's issued count are finished by one packed all-reduce a round.
The provenance record is whole on every rank: a round's allocation
stamps are the ranks' disjoint partials, summed with the witness row
(which one rank holds) in one packed all-reduce.

On a hierarchical ``("hosts", "nodes")`` mesh the node blocks are the
flat mesh's and every reduction, OR, AND and offset scan above runs the
engine's two-level circuits, ``dcn_mode`` scheduling their hosts level:
``sync`` or ``pipelined`` (bit-exact); ``stale:k`` refuses (offset
allocation and the lin-kv commits need the current round).  A ``words``
mesh refuses.  Not ported yet, and raising: the program audit (ROADMAP.md
Queue A item 14).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import faults, kernels, kvstore, provenance, telemetry, traffic
from .counter import KVReach, _reach, _unported
from .engine import (analytic_peak_bytes, check_mesh, collectives,
                     refuse_words, resolve_dcn_mode,
                     node_index, node_shards,
                     fori_rounds, operand_bytes, resolve_block,
                     resolve_device, scan_blocks)
from .faults import MASK32

# the reference's methods that this port leaves out, by ROADMAP.md Queue
# A item
_UNPORTED_METHODS = {"audit_observed_program": 14,
                     "audit_traffic_program": 14}


class KafkaState(NamedTuple):
    log_vals: torch.Tensor         # (K, C) int32
    present: torch.Tensor          # (N, K, Wc) int32 bits
    kv_val: torch.Tensor           # (K,) int32 — the shared lin-kv cells
    local_committed: torch.Tensor  # (N, K) int32 — kd.commitOffset
    origin_bits: torch.Tensor      # (N, K, Wc) push resync, else (N, K, 0)
    t: int                         # round counter
    msgs: torch.Tensor             # () int64 — a uint32 ledger
    # kv_backend="device": the store's rows, ``kv_val`` their view
    rows: kvstore.KVRows | None = None


def _rank_within_key(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(M,) int32 — for each element, how many valid earlier elements
    share its key: a stable sort of the keys (invalid ones last), then
    each position less the start of its run (a max scan of run starts)."""
    m = keys.shape[0]
    sort_keys = torch.where(valid, keys, 2 ** 30)
    sorted_keys, order = torch.sort(sort_keys, stable=True)
    pos = torch.arange(m, dtype=torch.int64, device=keys.device)
    is_start = torch.ones(m, dtype=torch.bool, device=keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    rank = torch.empty(m, dtype=torch.int32, device=keys.device)
    rank[order] = (pos - run_start).to(torch.int32)
    return rank


def _alloc(kv_val, send_key, reach, up_rows, k_dim: int, cap: int,
           exclusive_sum=None):
    """The round's offset allocator, linearized in (node, slot) order.
    Returns ``(tried, valid, keys_c, rank, slot, ok)`` over the flattened
    (rows S,) batch: ``tried`` a real op at an up node, ``valid`` tried
    and the KV reachable, ``ok`` valid and the slot within capacity (the
    acked sends).  On a mesh ``exclusive_sum`` (the collectives') adds
    the lower ranks' per-key counts of valid sends to each rank."""
    current = torch.where(kv_val > 0, kv_val, 1)
    s_dim = send_key.shape[1]
    loc_key = send_key.reshape(-1)
    tried = loc_key >= 0
    if up_rows is not None:
        # a down node submits nothing
        tried = tried & up_rows.repeat_interleave(s_dim)
    # a KV-blocked send never allocates
    valid = tried & reach.repeat_interleave(s_dim)
    keys_c = loc_key.clamp(0, k_dim - 1)
    rank = _rank_within_key(keys_c, valid)
    if exclusive_sum is not None:
        cnt = torch.zeros(k_dim, dtype=torch.int32,
                          device=keys_c.device).index_add_(
            0, keys_c.to(torch.int64), valid.to(torch.int32))
        rank = rank + exclusive_sum(cnt)[keys_c.to(torch.int64)]
    slot = current[keys_c.to(torch.int64)] + rank - 1
    return tried, valid, keys_c, rank, slot, valid & (slot < cap)


def _append(log_vals, ok, keys64, slot, vals):
    """(K, C) int32: ``log_vals`` with each acked send's value in its
    (key, slot) cell.  Offsets are unique per key, so the acked sends
    write distinct cells; the others write a dump cell past the end."""
    k_dim, cap = log_vals.shape
    kc = k_dim * cap
    cell = torch.where(ok, keys64 * cap + slot, kc)
    wvals = torch.zeros(kc + 1, dtype=torch.int32, device=log_vals.device)
    wvals[cell] = vals
    wrote = torch.zeros(kc + 1, dtype=torch.bool, device=log_vals.device)
    wrote[cell] = ok
    return torch.where(wrote[:kc], wvals[:kc],
                       log_vals.reshape(-1)).view(k_dim, cap)


def _send_bits(ok, keys64, slot, wc: int):
    """Each acked send's presence word ``key * Wc + slot // 32`` (int64,
    -1 for none) and its bit (int32, 0 for none)."""
    slot_ok = torch.where(ok, slot, 0).to(torch.int64)
    widx = torch.where(ok, keys64 * wc + slot_ok // 32, -1)
    return widx, kernels._wrap_i32(torch.where(ok, 1 << (slot_ok % 32), 0))


def _scatter_bits(at, ok, bit, size: int) -> torch.Tensor:
    """(size,) int32: the acked sends' bits summed into their words
    ``at``.  Offsets are unique, so no two bits collide and the sum is
    their OR."""
    return torch.zeros(size + 1, dtype=torch.int32,
                       device=bit.device).index_add_(
        0, torch.where(ok, at, size), bit)[:size]


class KafkaSim:
    """Round-synchronous replicated-log simulator: each round, each node
    submits up to S ``send`` ops and at most one ``commit_offsets`` op a
    key; :meth:`poll`, :meth:`list_committed` and :meth:`lin_kv` read the
    state with the reference's local-only semantics."""

    def __init__(self, n_nodes: int, n_keys: int, capacity: int, *,
                 max_sends: int = 4, mesh=None, kv_retries: int = 10,
                 kv_sched: KVReach | None = None,
                 repl_fast: bool | None = None,
                 fault_plan: faults.FaultPlan | None = None,
                 resync_every: int = 4, resync_mode: str = "pull",
                 union_block: int | str | None = None,
                 kv_backend: str = "host", kv_amnesia: bool = False,
                 dcn_mode=None,
                 device: str | torch.device | None = None) -> None:
        """The reference's arguments (its docstring has them in full):
        ``kv_sched`` the lin-kv reach windows; ``repl_fast`` the
        replication pick (False pins the matmul oracle); ``fault_plan``
        the crash / loss nemesis (its dup stream has no effect: replicate
        inserts are idempotent) with the periodic resync every
        ``resync_every`` rounds, ``"pull"`` or ``"push"``;
        ``union_block`` the destination slab of the faulted union (the
        same result at any size); ``kv_backend="device"`` the cells in
        the :mod:`.kvstore` rows, with ``kv_amnesia`` (a dup stream is
        refused).  ``device``: where the state lives (default CUDA;
        raises if there is none).  ``mesh``: a
        :class:`..parallel.mesh.Mesh`, this rank running its block of the
        rows on ``mesh.device`` (N must divide evenly; every rank calls
        every method in the same order).  ``dcn_mode``: the hosts level's
        schedule on a hierarchical mesh (:func:`.engine.resolve_dcn_mode`;
        None defers to the env); ``stale:k`` refuses."""
        if mesh is not None:
            check_mesh(mesh)
            refuse_words(mesh, "KafkaSim")
            if n_nodes % node_shards(mesh):
                raise ValueError(f"{n_nodes} nodes do not shard evenly "
                                 f"over {node_shards(mesh)} ranks")
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self._dcn = resolve_dcn_mode(dcn_mode)
        if self._dcn.stale_k:
            raise ValueError(
                f"dcn_mode={self._dcn.label()!r}: kafka has no "
                "certified staleness semantics — offset allocation is "
                "an exclusive prefix sum over the composed axes (a "
                "k-round-stale base double-allocates offsets) and the "
                "lin-kv commit dance needs the current cell; run sync "
                "or pipelined")
        if kv_backend not in ("host", "device"):
            raise ValueError(f"unknown kv_backend {kv_backend!r}")
        if kv_amnesia and kv_backend != "device":
            raise ValueError("kv_amnesia needs kv_backend='device'")
        if kv_backend == "device":
            kvstore.reject_dup_stream(fault_plan, "KafkaSim")
        if resync_mode not in ("pull", "push"):
            raise ValueError(f"unknown resync_mode {resync_mode!r}")
        if fault_plan is not None and fault_plan.n_nodes != n_nodes:
            raise ValueError(
                f"FaultPlan is for {fault_plan.n_nodes} nodes, sim has "
                f"{n_nodes}")
        self.device = resolve_device(device)
        self.mesh = mesh
        # this rank's rows: all of them off a mesh
        self._block = n_nodes if mesh is None else n_nodes // node_shards(mesh)
        self._row0 = 0 if mesh is None else node_index(mesh) * self._block
        self._coll = (None if mesh is None
                      else collectives(self._block, mesh, dcn=self._dcn))
        self.kv_backend = kv_backend
        self.kv_amnesia = bool(kv_amnesia)
        self._device_kv = kv_backend == "device"
        if self._device_kv:
            self._kv_layout = kvstore.make_layout(n_keys, n_nodes)
            self._slots = kvstore.key_slots(self._kv_layout, self.device)
            # a rank's share of the store: the keys its rows own
            self._block_slots = kvstore.block_slots(
                self._kv_layout, self._row0, self._block, self.device)
        self.n_nodes = n_nodes
        self.n_keys = n_keys
        self.capacity = capacity
        self.n_pwords = (capacity + 31) // 32   # presence words a key
        self.max_sends = max_sends
        self.kv_retries = kv_retries
        self.kv_sched = (KVReach.none(n_nodes, self.device) if kv_sched is None
                         else kv_sched.to(self.device))
        if self.kv_sched.blocked.shape[1:] != (n_nodes,):
            raise ValueError(f"KVReach blocked "
                             f"{tuple(self.kv_sched.blocked.shape)} is not "
                             f"(P, {n_nodes})")
        self.repl_fast = repl_fast
        self.fault_plan = (None if fault_plan is None
                           else fault_plan.to(self.device))
        self.resync_every = resync_every
        self.resync_mode = resync_mode
        self._push = resync_mode == "push"
        # a crash / loss plan drives the round (a dup-only plan is inert)
        self._fp_active = fault_plan is not None and (
            len(fault_plan.starts) > 0 or fault_plan.loss_num > 0)
        # the resync runs only under a plan that downs a node or loses
        # messages (a window over no node counts as none); the plan is
        # static, so this is read once
        self._fp_on = self._fp_active and (
            fault_plan.loss_num > 0 or bool(fault_plan.down.any()))
        # each destination row of the faulted union hashes N S coins; only
        # the plain version holds them as a tensor, so off a mesh on the
        # card "auto" is one launch over all rows (an integer keeps its
        # slabs); on a mesh the slab resolves as the reference's, over
        # the rank's rows at N S coins a row
        coin_bytes = (0 if self.device.type == "cuda" and mesh is None
                      else 4)
        self._ub = resolve_block(self._block, union_block,
                                 per_row_bytes=n_nodes * max_sends
                                 * coin_bytes)
        # the global ids of this rank's rows, and of every row
        self._row_ids = torch.arange(self._row0, self._row0 + self._block,
                                     dtype=torch.int32, device=self.device)
        self._all_ids = torch.arange(n_nodes, dtype=torch.int32,
                                     device=self.device)
        self._traffic = {}

    def __getattr__(self, name: str):
        if name in _UNPORTED_METHODS:
            raise _unported(f"KafkaSim.{name}", _UNPORTED_METHODS[name])
        raise AttributeError(name)

    def init_state(self) -> KafkaState:
        """The round-0 state (this rank's block of the rows on a mesh)."""
        n, k, c, wc = self._block, self.n_keys, self.capacity, self.n_pwords
        dev = self.device

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        return KafkaState(
            log_vals=torch.full((k, c), -1, dtype=torch.int32, device=dev),
            present=z(n, k, wc), kv_val=z(k), local_committed=z(n, k),
            origin_bits=z(n, k, wc if self._push else 0), t=0,
            msgs=torch.zeros((), dtype=torch.int64, device=dev),
            rows=(kvstore.init_rows(self._kv_layout, dev, rows=n)
                  if self._device_kv else None))

    # -- round -----------------------------------------------------------

    def _is_resync(self, t: int) -> bool:
        """The resync runs every ``resync_every``-th round after round 0
        under an active plan; ``resync_every=0`` every round, as the
        reference's ``t % 0`` is 0."""
        return (self._fp_on and t > 0 and (self.resync_every == 0
                                           or t % self.resync_every == 0))

    def _alloc_inputs(self, t: int) -> tuple:
        """Round ``t``'s allocation operands: every node's KV reach, and
        its liveness under an active plan (else None).  Down nodes cannot
        reach the KV; loss eats one round's exchange."""
        rows = self._row_ids
        reach = _reach(t, rows, self.kv_sched)
        if not self._fp_active:
            return reach, None
        plan = self.fault_plan
        up = faults.node_up(plan, t, rows)
        return reach & up & ~faults.kv_drop(plan, t, rows), up

    def _round(self, state: KafkaState, send_key: torch.Tensor,
               send_val: torch.Tensor, commit_req: torch.Tensor | None,
               repl_ok, repl_mode: str, alloc=None) -> KafkaState:
        """One round on ``state``, whose ``present``, ``local_committed``
        and ``origin_bits`` it updates in place: allocate, append and
        replicate the (rows, S) sends, then run the (rows, K) commits
        (None: none).  ``repl_ok``: the (N, N) bool link mask of the
        matmul path on the sim's device.  ``alloc``: this round's
        :func:`_alloc` of the sends, already evaluated by the caller on
        the same operands (the traffic driver's; never with the device
        KV, whose cells the round reads from its rows).  On a mesh the
        rows are this rank's block and the round's collectives are the
        module docstring's."""
        n, k_dim, cap, wc = (self.n_nodes, self.n_keys, self.capacity,
                             self.n_pwords)
        rows = self._block
        mesh = self.mesh
        s_dim = send_key.shape[1]
        t = state.t
        row_ids = self._row_ids
        plan = self.fault_plan if self._fp_active else None
        reach, up = self._alloc_inputs(t)
        wipe = None if plan is None else faults.amnesia(plan, t, row_ids)
        present, lc, origin = (state.present, state.local_committed,
                               state.origin_bits)
        kv_val, rows_kv = state.kv_val, state.rows
        if self._device_kv:
            # the cells are read from the store's rows (on a mesh each
            # key from its owner rank, through one all-reduce)
            if plan is not None and self.kv_amnesia:
                rows_kv = kvstore.rows_wipe(rows_kv, plan, t, row_ids)
            kv_val = (kvstore.rows_view_at(rows_kv, self._slots)[0]
                      if mesh is None else
                      kvstore.rows_view_block(rows_kv, self._block_slots,
                                              k_dim,
                                              self._coll.reduce_sum)[0])

        # -- allocation and append
        current = torch.where(kv_val > 0, kv_val, 1)
        tried, valid, keys_c, rank, slot, ok = (
            _alloc(kv_val, send_key, reach, up, k_dim, cap,
                   None if mesh is None else self._coll.exclusive_sum)
            if alloc is None else alloc)
        keys64 = keys_c.to(torch.int64)
        # the ledger of the sends: a send of rank r retries its CAS r
        # times (4 messages an attempt, at most kv_retries attempts), a
        # KV-blocked send costs its one lost read, and every acked send
        # N - 1 replicate messages
        attempts = torch.clamp(rank.to(torch.int64) + 1, max=self.kv_retries)
        ledger = torch.stack([torch.where(valid, 4 * attempts, 0).sum(),
                              (tried & ~valid).sum(), ok.sum()])
        if mesh is None:
            log_vals = _append(state.log_vals, ok, keys64, slot,
                               send_val.reshape(-1))
            counts = torch.zeros(k_dim, dtype=torch.int32,
                                 device=self.device).index_add_(
                0, keys64, ok.to(torch.int32))
        else:
            log_vals, counts, ledger = self._append_mesh(
                state.log_vals, ok, keys64, slot, send_val.reshape(-1),
                ledger)
        kv_sent = torch.where(counts > 0, current + counts, kv_val)
        msgs = state.msgs + ledger[0] + ledger[1] + ledger[2] * (n - 1)

        # -- each acked send's presence word and bit
        widx, bit = _send_bits(ok, keys64, slot, wc)
        kw = k_dim * wc
        own = None
        if repl_mode == "matmul" or self._push:
            node = torch.arange(rows, device=self.device).repeat_interleave(
                s_dim)
            at = torch.where(ok, node * kw + widx, 0)
        if self._push:
            # the durable per-origin record: origin |= own, as a sum of
            # the bits not yet set (disjoint within the round)
            flat = origin.view(-1)
            flat.index_add_(0, at, torch.where(ok, bit & ~flat[at], 0))
        if repl_mode == "matmul":
            own = _scatter_bits(at, ok, bit, rows * kw).view(rows, k_dim, wc)

        # -- replication and the merge
        merge = dict(wipe=wipe)
        if repl_mode == "union":
            row = _scatter_bits(widx, ok, bit, kw).view(k_dim, wc)
            merge["row"] = row if mesh is None else self._coll.reduce_or(row)
        elif repl_mode == "union_nem":
            merge["carry"] = self._nem_deliver(present, widx.to(torch.int32),
                                               bit, up, s_dim, plan, t)
        else:
            merge.update(carry=self._matmul_deliver(own, repl_ok, plan, t),
                         own=own)
        rs = self._is_resync(t)
        if rs:
            merge.update(resync=(kernels.RESYNC_PUSH if self._push
                                 else kernels.RESYNC_PULL),
                         live=up, origin=origin if self._push else None)
        union, any_origin = kernels.kafka_merge(present, lc, **merge)
        if rs and mesh is not None:
            # the merge's union is the rank's partial
            union = self._coll.reduce_or(union)

        # -- the resync's take and the commits
        kv_new = kv_sent
        if rs or commit_req is not None:
            # the resync's ledger: a pull request and its reply a live
            # node, or N - 1 replicate messages a live pusher
            tally = None
            if rs:
                tally = up & (any_origin != 0) if self._push else up
            mult = n - 1 if self._push else 2
            cas_win, wrt_last, tot = kernels.kafka_commit_select(
                present, lc, take=up if rs else None, union=union,
                req=commit_req, want_ok=up, reach=reach, kv_sent=kv_sent,
                tally=tally, row0=self._row0, n_total=n)
            akw = dict(kv_retries=self.kv_retries, tally_mult=mult)
            if commit_req is None:
                if mesh is not None:
                    tot = self._coll.reduce_sum(tot)
                msgs = msgs + mult * tot[3]
            elif mesh is None:
                kv_new, msgs = kernels.kafka_commit_apply(
                    lc, commit_req, cas_win, wrt_last, kv_sent, reach, up,
                    tot, msgs, **akw)
            else:
                # the winners over the ranks: the least CAS row and the
                # greatest writer row in one minimum
                win = self._coll.reduce_min(torch.stack([cas_win,
                                                         -wrt_last]))
                cas_win, wrt_last = win[0], -win[1]
                part = kernels.kafka_commit_apply(
                    lc, commit_req, cas_win, wrt_last, kv_sent, reach, up,
                    None, None, row0=self._row0, n_total=n, partial=True,
                    **akw)
                g = self._coll.reduce_sum(torch.cat(
                    [part.reshape(-1).to(torch.int64), tot]))
                kv_new, msgs = kernels.commit_finish(
                    g[:2 * k_dim].view(2, k_dim), cas_win, wrt_last, kv_sent,
                    g[2 * k_dim:], msgs, n_total=n, **akw)
        msgs = msgs & MASK32
        if self._device_kv:
            # the round's net cell updates as one CAS a key from the view
            # (on a mesh into the owner rank's rows)
            on, frm, to = kv_new != kv_val, kv_val, kv_new
            slots = self._slots
            if mesh is not None:
                slots, keys = self._block_slots
                on, frm, to = on[keys], frm[keys], to[keys]
            rows_kv = kvstore.cas_apply_at(rows_kv, slots, on, frm, to,
                                           donate=True)
        return KafkaState(log_vals, present, kv_new, lc, origin, t + 1, msgs,
                          rows=rows_kv)

    def _append_mesh(self, log_vals, ok, keys64, slot, vals, ledger):
        """The append on a mesh: each rank's acked sends packed into their
        (key, slot) cells as ``1 << 32 | value`` (offsets are unique, so
        one rank writes a cell), beside the per-key counts of acked sends
        and the send ledger, summed over the ranks in one all-reduce.
        Returns the replicated ``log_vals``, the counts and the global
        ledger."""
        k_dim, cap = log_vals.shape
        kc = k_dim * cap
        packed = torch.zeros(kc + 1 + k_dim + 3, dtype=torch.int64,
                             device=log_vals.device)
        cell = torch.where(ok, keys64 * cap + slot, kc)
        packed[cell] = torch.where(ok, (vals.to(torch.int64) & MASK32)
                                   | (1 << 32), 0)
        packed[kc + 1:kc + 1 + k_dim].index_add_(0, keys64,
                                                 ok.to(torch.int64))
        packed[kc + 1 + k_dim:] = ledger
        g = self._coll.reduce_sum(packed)
        cells = g[:kc]
        log_vals = torch.where((cells >> 32) > 0,
                               kernels._wrap_i32(cells & MASK32),
                               log_vals.reshape(-1)).view(k_dim, cap)
        return (log_vals, g[kc + 1:kc + 1 + k_dim].to(torch.int32),
                g[kc + 1 + k_dim:])

    def _nem_deliver(self, present, widx32, bit, up, s_dim: int, plan,
                     t: int) -> torch.Tensor:
        """The faulted origin union's delivery (rows, K, Wc): every row's
        surviving bits of the round's sends, over all rows at once or in
        ``union_block`` slabs.  On a mesh the materialized form widens the
        sends' packed metadata to all N origins (one all-gather); the
        blocked form passes each rank's metadata block round the ring
        (a ppermute a step), ORing each visiting block's bits in."""
        rows = self._block
        loss_num = plan.loss_num if t < plan.loss_until else 0
        kw = dict(s_dim=s_dim, t=t, seed=plan.seed, loss_num=loss_num,
                  row0=self._row0)
        deliver = torch.empty_like(present)
        ub = self._ub

        def sweep(meta, origin0: int, acc: bool):
            def slab(carry, lo):
                kernels.kafka_nem_deliver(
                    carry, meta[0], meta[1], up, lo=lo,
                    hi=lo + (rows if ub is None else ub), origin0=origin0,
                    accumulate=acc, **kw)
                return carry

            scan_blocks(slab, deliver, rows, rows if ub is None else ub)

        mesh = self.mesh
        if mesh is None:
            sweep((widx32, bit), 0, False)
            return deliver
        meta = torch.stack([widx32, bit])
        if ub is None:
            g = mesh.all_gather(meta, dim=1)
            sweep((g[0].contiguous(), g[1].contiguous()), 0, False)
            return deliver
        k, p = node_shards(mesh), node_index(mesh)
        for step in range(k):
            # after ``step`` rotations the block came from rank p - step
            sweep((meta[0].contiguous(), meta[1].contiguous()),
                  (p - step) % k * rows, step > 0)
            if step + 1 < k:
                meta = mesh.ppermute(meta, [(q, (q + 1) % k)
                                            for q in range(k)])
        return deliver

    def _matmul_deliver(self, own, repl_ok, plan, t: int) -> torch.Tensor:
        """The link-mask delivery of this rank's rows: the masked OR over
        origins of their new words as a matrix product of byte planes
        (disjoint bits keep every byte sum <= 255, exact in float16 on the
        card, float32 on the CPU), composed with the plan's liveness and
        loss coins.  On a mesh the origins' words are the ranks' own
        words gathered (one all-gather), the mask the rank's columns."""
        n, k_dim, wc = self.n_nodes, self.n_keys, self.n_pwords
        rows, r0 = self._block, self._row0
        if self.mesh is not None:
            own = self._coll.widen(own)
        ok = repl_ok[:, r0:r0 + rows]
        if plan is not None:
            ids = self._all_ids
            up_all = faults.node_up(plan, t, ids)
            ok = (ok & up_all[:, None] & up_all[None, r0:r0 + rows]
                  & ~faults.edge_drop(plan, t, ids[:, None],
                                      self._row_ids[None, :]))
        dtype = torch.float32 if self.device.type == "cpu" else torch.float16
        shifts = torch.arange(0, 32, 8, device=self.device)
        planes = (own.to(torch.int64)[..., None] >> shifts) & 0xFF
        prod = ok.t().to(dtype) @ planes.reshape(n, -1).to(dtype)
        db = prod.round().to(torch.int64).view(rows, k_dim, wc, 4)
        return kernels._wrap_i32((db << shifts).sum(-1))

    def _repl_mode(self, repl_ok) -> str:
        """The replication pick: the unions where every link delivers
        (``repl_ok`` None or all True) — ``union_nem`` under an active
        plan — unless ``repl_fast=False`` pins the matmul, which an
        explicit partial ``repl_ok`` always takes."""
        if self.repl_fast is False:
            return "matmul"
        if not (repl_ok is None or bool(np.all(repl_ok))):
            return "matmul"
        return "union_nem" if self._fp_active else "union"

    def union_footprint(self, *, block: int | None | str = "resolved",
                        donated: bool = True) -> dict:
        """The reference's analytic footprint of one faulted ``union_nem``
        round (:func:`.engine.analytic_peak_bytes`): the state, the plan's
        leaves, and the coin slab (``block`` x N S hashes; the whole
        (rows, N S) tensor for ``block=None``) plus the (rows, K, Wc)
        delivery carry, rows a rank's on a mesh.  ``block="resolved"``
        takes this sim's slab.  This models the reference's round and the
        CPU's plain version; the card's kernel hashes its coins in
        registers and holds no coin slab."""
        rows = self._block
        if block == "resolved":
            block = self._ub
        eff = rows if block is None else int(block)
        n, k, wc = self.n_nodes, self.n_keys, self.n_pwords
        state = (n * k * wc * 4 + k * self.capacity * 4 + k * 4
                 + n * k * 4 + (n * k * wc * 4 if self._push else 0))
        coin = eff * n * self.max_sends * 4
        deliver = rows * k * wc * 4
        out = analytic_peak_bytes(state_bytes=state,
                                  operand_bytes=operand_bytes(
                                      self.fault_plan),
                                  slab_bytes=coin + deliver,
                                  donated=donated)
        out.update(block=eff if block is not None else None,
                   coin_slab_bytes=coin, deliver_carry_bytes=deliver,
                   materialized=block is None)
        return out

    # -- drivers ---------------------------------------------------------

    def _ints(self, x, node_axis: int | None = None) -> torch.Tensor:
        """int32 on the sim's device, from numpy or a tensor (a batch
        staged on the device stays there); on a mesh, with ``node_axis``,
        this rank's block of that axis of the full operand."""
        if self.mesh is not None and node_axis is not None:
            if x.shape[node_axis] != self.n_nodes:
                raise ValueError(
                    f"on a mesh the operands carry all {self.n_nodes} "
                    f"rows on axis {node_axis}, got {tuple(x.shape)}")
            if not isinstance(x, torch.Tensor):
                x = np.take(np.asarray(x), np.arange(
                    self._row0, self._row0 + self._block), axis=node_axis)
            else:
                x = x.narrow(node_axis, self._row0, self._block)
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32).contiguous()
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=self.device)

    def _copy(self, state: KafkaState) -> KafkaState:
        rows = state.rows
        if rows is not None:
            rows = kvstore.KVRows(rows.vals.clone(), rows.vers.clone())
        return state._replace(present=state.present.clone(),
                              local_committed=state.local_committed.clone(),
                              origin_bits=state.origin_bits.clone(),
                              rows=rows)

    def _staged(self, repl_ok):
        """The replication path and, for the matmul, its link mask on the
        device (all True when none is given)."""
        mode = self._repl_mode(repl_ok)
        if mode != "matmul":
            return mode, None
        if repl_ok is None:
            return mode, torch.ones((self.n_nodes, self.n_nodes),
                                    dtype=torch.bool, device=self.device)
        return mode, torch.as_tensor(np.asarray(repl_ok, bool),
                                     device=self.device)

    def step(self, state: KafkaState, send_key=None, send_val=None,
             commit_req=None, repl_ok=None) -> KafkaState:
        """One round of (N, S) sends and (N, K) commits (None: none) on a
        copy of ``state``."""
        n, s = self.n_nodes, self.max_sends
        if send_key is None:
            send_key = np.full((n, s), -1, np.int32)
            send_val = np.zeros((n, s), np.int32)
        mode, repl_ok = self._staged(repl_ok)
        return self._round(self._copy(state), self._ints(send_key, 0),
                           self._ints(send_val, 0),
                           None if commit_req is None
                           else self._ints(commit_req, 0), repl_ok, mode)

    def run_rounds(self, state: KafkaState, send_key, send_val,
                   commit_req=None, repl_ok=None) -> KafkaState:
        """R staged rounds: ``send_key`` / ``send_val`` (R, N, S),
        ``commit_req`` (R, N, K) or None (commit-free: the commit passes
        do not run).  The input state stays as it was."""
        return self.run_fused(self._copy(state), send_key, send_val,
                              commit_req, repl_ok)

    def run_fused(self, state: KafkaState, send_key, send_val,
                  commit_req=None, repl_ok=None) -> KafkaState:
        """:meth:`run_rounds` in place: every round updates the presence,
        the committed cache, the origin bits and the KV rows of the state
        passed in, which must not be used again."""
        mode, repl_ok = self._staged(repl_ok)
        sks, svs = self._ints(send_key, 1), self._ints(send_val, 1)
        crs = None if commit_req is None else self._ints(commit_req, 1)
        r = iter(range(sks.shape[0]))

        def body(st):
            i = next(r)
            return self._round(st, sks[i], svs[i],
                               None if crs is None else crs[i], repl_ok,
                               mode)

        return fori_rounds(body, state, sks.shape[0])

    # -- open-loop traffic -----------------------------------------------

    def _traffic_index(self, tspec) -> dict:
        """The traffic driver's per-spec index tensors
        (:func:`.traffic.client_index` and the op slots), cached by the
        spec's static key."""
        key = tspec.program_key
        if key not in self._traffic:
            ix = traffic.client_index(tspec, self.n_nodes, self.device,
                                      self.mesh)
            if self._repl_mode(None) == "matmul":
                raise ValueError(
                    "traffic drivers ride the origin-union replication "
                    "paths; repl_fast=False pins the matmul oracle — "
                    "compare blocked vs materialized via union_block "
                    "instead")
            ix["kk"] = torch.arange(tspec.ops_per_client, dtype=torch.int64,
                                    device=self.device)
            self._traffic[key] = ix
        return self._traffic[key]

    def _op_keys(self, seed: int, ids: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
        """int64 key of op (client, slot) (broadcast): a hash of the plan's
        seed, the client and the slot, mod ``n_keys`` (unsigned)."""
        kx = faults._mix32(faults._mul32(ids & MASK32, 0xC2B2AE35)
                           ^ faults._mul32(slots & MASK32, 0x9E3779B9)
                           ^ seed ^ traffic.SALT_KEY)
        return kx % self.n_keys

    def _traffic_round(self, state: KafkaState, ts, tspec, tplan, ix: dict,
                       repl_mode: str, op_keys: torch.Tensor, tel=None,
                       tel_mask=None):
        """One traffic-injected round (the reference's): stage this
        round's arrivals as the send batch (op (client, k) sends its
        seeded key with its op id as the value), evaluate the round's
        allocator to learn which sends are acked, run the round on it,
        then advance the tracker.  Deferrals: home node down, node intake
        saturated (more arrivals than ``max_sends`` slots, or the spec's
        tighter ``intake``), op slots exhausted, and the allocation
        failing (KV unreachable, or the key full).  An op completes when
        its (key, slot) bit is present at every node."""
        t, node, ids = state.t, ix["node"], ix["ids"]
        n, s_dim = self._block, self.max_sends
        mesh = self.mesh
        red = None if mesh is None else self._coll.reduce_sum
        plan = self.fault_plan if self._fp_active else None
        arr = traffic.arrive(tplan, t, ids)
        up_cl = (faults.node_up(plan, t, ix["node_ids"]) if plan is not None
                 else torch.ones_like(arr))
        cap_in = s_dim if tspec.intake is None else min(tspec.intake, s_dim)
        rank = traffic.intake_rank(arr, tspec.clients_per_node)
        gate = up_cl & (rank < cap_in)
        cand = arr & gate & (ts.issued_k < tspec.ops_per_client)
        kslot = ts.issued_k.to(torch.int64)
        # the send batch, one dump slot past its end for the others
        at = torch.where(cand, node * s_dim + rank, n * s_dim)
        send_key = torch.full((n * s_dim + 1,), -1, dtype=torch.int32,
                              device=self.device)
        send_key[at] = self._op_keys(tplan.seed, ids, kslot).to(torch.int32)
        send_val = torch.zeros_like(send_key)
        send_val[at] = (ids * tspec.ops_per_client + kslot).to(torch.int32)
        send_key = send_key[:-1].view(n, s_dim)
        send_val = send_val[:-1].view(n, s_dim)
        # the round's allocator, on the operands the round gives it
        alloc = _alloc(state.kv_val, send_key, *self._alloc_inputs(t),
                       self.n_keys, self.capacity,
                       None if mesh is None else self._coll.exclusive_sum)
        slot, ok_flat = alloc[4], alloc[5]
        fi = torch.where(cand, node * s_dim + rank, 0)
        ts, ok, kslot = traffic.issue(ts, arr, cand & ok_flat[fi], t, red)
        ts = traffic.record_aux(ts, ok, kslot, slot[fi])
        s2 = self._round(state, send_key, send_val, None, None, repl_mode,
                         alloc=None if self._device_kv else alloc)
        k_dim, wc = self.n_keys, self.n_pwords
        all_pres = kernels.and_fold(s2.present.view(n, k_dim * wc),
                                    node_major=True)
        if mesh is not None:
            all_pres = self._coll.reduce_and(all_pres)
        aux = ts.op_aux

        def bit_fn(lo, block):
            a = aux[lo:lo + block]
            sl = a.clamp(min=0).to(torch.int64)
            word = all_pres[op_keys[lo:lo + block] * wc + sl // 32]
            return (a >= 0) & (((word >> (sl % 32).to(torch.int32)) & 1) > 0)

        ts = traffic.done_scan(ts, bit_fn, s2.t, ix["block"], red)
        if tel is None:
            return s2, ts, None
        vals = (self._tel_series(state.t, s2, tel_mask)
                + traffic.tel_series(ts))
        return s2, ts, self._record(tel, t, vals, tel_mask,
                                    traffic.TRAFFIC_PARTIAL)

    def _record(self, tel, t: int, vals, mask, extra=()):
        """:func:`.telemetry.record` of a row, its partial columns (the
        presence popcounts) summed over a mesh."""
        partial = (False, False, True, True, False) + tuple(extra)
        return telemetry.record(tel, t, vals, mask, partial,
                                None if self.mesh is None
                                else self._coll.reduce_sum)

    def _tel_series(self, t: int, s1: KafkaState, mask) -> tuple:
        """One round's telemetry row (``telemetry.SIM_SERIES['kafka']``):
        liveness at round ``t``, the slots allocated, the presence
        popcount at the witness node 0, the full-cluster presence
        popcount (opt-in), the message total."""
        plan = self.fault_plan if self._fp_active else None

        def pc(x):
            return kernels.popcount(x).sum(dtype=torch.int64)

        # the witness row 0 lies in rank 0's block (the others add 0)
        witness = (pc(s1.present[0]) if self._row0 == 0
                   else torch.zeros((), dtype=torch.int64,
                                    device=self.device))
        return (telemetry.live_count(plan, t, self.n_nodes) if mask[0]
                else None,
                (s1.log_vals >= 0).sum(dtype=torch.int64) if mask[1]
                else None,
                witness if mask[2] else None,
                pc(s1.present) if mask[3] else None, s1.msgs)

    def telemetry_state(self, tel_spec) -> "telemetry.TelemetryState":
        return telemetry.init_state(tel_spec, device=self.device)

    # -- observed runs: the telemetry ring and the provenance record -------

    def provenance_state(self, pspec) -> "provenance.KafkaProv":
        return provenance.init_kafka(self.n_keys, self.capacity,
                                     device=self.device)

    def _prov_record(self, alloc: tuple, s2: KafkaState, prov,
                     witness: int):
        """One round's provenance stamps (the reference's), first
        occurrence only: each acked send's (key, slot) gets the round
        after and its origin node, from the round's own :func:`_alloc`
        evaluation ``alloc``; each slot newly present at the ``witness``
        node (a global row) after the round gets the round after.  On a
        mesh ``alloc`` covers the rank's rows (global row ids): the
        ranks' stamps are disjoint partials (offsets are unique per key)
        and the witness row lies in one rank's block, so one packed
        all-reduce sums both into identical copies."""
        _tried, _valid, keys_c, _rank, slot, ok = alloc
        k_dim, cap = self.n_keys, self.capacity
        kc = k_dim * cap
        # offsets are unique per key: the acked sends write distinct
        # cells, the others a dump cell past the end
        cell = torch.where(ok, keys_c.to(torch.int64) * cap + slot, kc)
        origin = self._row_ids.repeat_interleave(ok.shape[0] // self._block)
        t1 = s2.t
        ar = torch.zeros(kc + 1, dtype=torch.int32, device=self.device)
        ar[cell] = torch.where(ok, t1, 0).to(torch.int32)
        og = torch.zeros(kc + 1, dtype=torch.int32, device=self.device)
        og[cell] = torch.where(ok, origin + 1, 0).to(torch.int32)
        ar, og = ar[:kc].view(k_dim, cap), og[:kc].view(k_dim, cap)
        loc = witness - self._row0
        if self.mesh is None:
            wrow = s2.present[witness]
        else:
            mine = 0 <= loc < self._block
            wrow = (s2.present[loc] if mine
                    else torch.zeros_like(s2.present[0]))
            g = self._coll.reduce_sum(torch.cat(
                [ar.reshape(-1), og.reshape(-1), wrow.reshape(-1)]))
            ar, og = g[:kc].view(k_dim, cap), g[kc:2 * kc].view(k_dim, cap)
            wrow = g[2 * kc:].view(wrow.shape)
        new_alloc = (ar > 0) & (prov.alloc_round < 0)
        return provenance.KafkaProv(
            alloc_round=torch.where(new_alloc, ar, prov.alloc_round),
            origin=torch.where(new_alloc, og - 1, prov.origin),
            first_present=provenance.stamp(
                prov.first_present, kernels.unpack_bits(wrow, cap), t1))

    def run_observed(self, state: KafkaState, tel, tspec, send_key,
                     send_val, commit_req=None, *, donate: bool = False,
                     prov=None, prov_spec=None):
        """:meth:`run_rounds` with the per-round telemetry ring (``tel`` /
        ``tspec``, a ``TelemetrySpec(traffic=False)``) and / or the
        per-(key, slot) allocation, origin and witness-presence stamps
        (``prov`` / ``prov_spec``) recorded beside the state, which they
        only read: the state equals the plain drivers' bit for bit.  The
        allocator is evaluated once a round and handed to the round (as
        the traffic driver does; the device KV's round reads its own).
        With ``donate`` the state and the ring are updated in place, else
        copied first.  Returns ``(state, tel?, prov?)``.  On a mesh the
        record is whole on every rank and a round makes one all-reduce
        more (:meth:`_prov_record`)."""
        if (tel is None) != (tspec is None):
            raise ValueError(
                "pass tel and tel_spec together (build the ring with "
                "telemetry.init_state(spec))")
        provenance.prov_key(prov, prov_spec, "kafka")
        if tspec is None and prov_spec is None:
            raise ValueError(
                "observed drivers need a TelemetrySpec and/or a "
                "ProvenanceSpec")
        if tspec is not None and (tspec.workload != "kafka"
                                  or tspec.traffic):
            raise ValueError(
                "run_observed needs a TelemetrySpec(workload='kafka', "
                "traffic=False); open-loop runs record through "
                "run_traffic(tel=...)")
        if prov_spec is not None and prov_spec.witness >= self.n_nodes:
            raise ValueError(
                f"provenance witness {prov_spec.witness} out of range "
                f"for {self.n_nodes} nodes")
        repl_mode = self._repl_mode(None)
        if repl_mode == "matmul":
            raise ValueError(
                "observed drivers ride the origin-union replication "
                "paths; repl_fast=False pins the matmul oracle")
        sks, svs = self._ints(send_key, 1), self._ints(send_val, 1)
        crs = None if commit_req is None else self._ints(commit_req, 1)
        if not donate:
            state = self._copy(state)
            tel = None if tel is None else tel.clone()
        mask = None if tel is None else tspec.static_mask
        for i in range(sks.shape[0]):
            t = state.t
            alloc = _alloc(state.kv_val, sks[i], *self._alloc_inputs(t),
                           self.n_keys, self.capacity,
                           None if self.mesh is None
                           else self._coll.exclusive_sum)
            state = self._round(state, sks[i], svs[i],
                                None if crs is None else crs[i], None,
                                repl_mode,
                                alloc=None if self._device_kv else alloc)
            if tel is not None:
                tel = self._record(tel, t, self._tel_series(t, state, mask),
                                   mask)
            if prov is not None:
                prov = self._prov_record(alloc, state, prov,
                                         prov_spec.witness)
        return ((state,) + (() if tel is None else (tel,))
                + (() if prov is None else (prov,)))

    def traffic_state(self, tspec) -> "traffic.TrafficState":
        """An empty tracker (a rank's block of the clients on a mesh)."""
        return traffic.init_state(tspec, self.mesh, device=self.device)

    def run_traffic(self, state: KafkaState, ts, tspec, n_rounds: int, *,
                    donate: bool = False, tel=None, tel_spec=None):
        """Open-loop serving driver: ``n_rounds`` rounds, each staging the
        spec's seeded arrivals through the send path (allocation, append,
        replication; ``union`` or ``union_nem``, materialized or in
        ``union_block`` slabs) and advancing the per-op latency tracker.
        With ``donate`` the state, the tracker and the ring are updated
        in place; else they are copied first.  ``tel`` / ``tel_spec``:
        record the telemetry ring too, and return ``(state, ts,
        tel)``."""
        telemetry.tel_key(tel, tel_spec, "kafka")
        ix = self._traffic_index(tspec)
        tplan = tspec.compile()
        repl_mode = self._repl_mode(None)
        op_keys = self._op_keys(tplan.seed, ix["ids"][:, None],
                                ix["kk"][None, :])
        if not donate:
            state = self._copy(state)
            ts = ts.clone()
            tel = None if tel is None else tel.clone()
        mask = None if tel is None else tel_spec.static_mask
        for _ in range(n_rounds):
            state, ts, tel = self._traffic_round(state, ts, tspec, tplan, ix,
                                                 repl_mode, op_keys, tel,
                                                 mask)
        return (state, ts) if tel is None else (state, ts, tel)

    # -- reads -----------------------------------------------------------

    def alloc_offsets(self, state_before: KafkaState,
                      send_key: np.ndarray) -> np.ndarray:
        """(N, S) int32 — the offsets this round's sends were acked with,
        or -1: the round's allocator on the device, gated by the host's
        reach at ``state_before.t``.  On a mesh every rank ranks the whole
        batch against the replicated cells: no collective."""
        t = state_before.t
        reach = np.ones(self.n_nodes, bool)
        blocked = self.kv_sched.blocked.cpu().numpy()
        for w, (lo, hi) in enumerate(zip(self.kv_sched.starts,
                                         self.kv_sched.ends)):
            if lo <= t < hi:
                reach &= ~blocked[w]
        if self.fault_plan is not None:
            reach &= faults.host_kv_ok(self.fault_plan, t)
        sk = self._ints(send_key)
        flat = sk.reshape(-1)
        valid = (flat >= 0) & torch.as_tensor(
            reach, device=self.device).repeat_interleave(sk.shape[1])
        keys_c = flat.clamp(0, self.n_keys - 1)
        kv = state_before.kv_val
        off = (torch.where(kv > 0, kv, 1)[keys_c.to(torch.int64)]
               + _rank_within_key(keys_c, valid))
        ok = valid & (off - 1 < self.capacity)
        return torch.where(ok, off, -1).reshape(sk.shape).cpu().numpy()

    def poll_batch_program(self):
        """The batched poll as a device function ``(present, log_vals,
        nodes, keys, from_offsets) -> (offsets, msgs)``: (Q,) int32
        queries, (Q, capacity) padded answers (offset -1: an empty
        slot)."""
        cap = self.capacity

        def pb(present, log_vals, nodes, keys, from_off):
            nodes, keys = nodes.to(torch.int64), keys.to(torch.int64)
            return _poll_words(present[nodes, keys], log_vals, keys,
                               from_off, cap)

        return pb

    def poll_batch(self, state: KafkaState, nodes, keys,
                   from_offsets) -> tuple[np.ndarray, np.ndarray]:
        """The LOCAL-log poll of Q (node, key, from_offset) queries:
        padded ``(offsets, msgs)`` (Q, capacity) arrays, offset -1 an
        empty slot, offset-ascending by layout.  On a mesh each rank
        contributes the words of the queried nodes in its block, summed
        in one all-reduce."""
        nodes, keys = self._ints(nodes), self._ints(keys)
        from_off = self._ints(from_offsets)
        if self.mesh is None:
            offs, vals = self.poll_batch_program()(
                state.present, state.log_vals, nodes, keys, from_off)
        else:
            loc = nodes.to(torch.int64) - self._row0
            inb = (loc >= 0) & (loc < self._block)
            k64 = keys.to(torch.int64)
            words = torch.where(
                inb[:, None],
                state.present[loc.clamp(0, self._block - 1), k64], 0)
            offs, vals = _poll_words(self._coll.reduce_sum(words),
                                     state.log_vals, k64, from_off,
                                     self.capacity)
        return offs.cpu().numpy(), vals.cpu().numpy()

    def poll(self, state: KafkaState, node: int, key: int,
             from_offset: int) -> list[list[int]]:
        """[[offset, msg], ...] from the node's LOCAL log."""
        offs, vals = self.poll_batch(state, [node], [key], [from_offset])
        sel = offs[0] >= 0
        return [[int(o), int(v)] for o, v in zip(offs[0][sel],
                                                 vals[0][sel])]

    def present_bool(self, state: KafkaState) -> np.ndarray:
        """(N, K, C) bool — the presence bits unpacked on the host (on a
        mesh every rank's block, gathered)."""
        present = state.present if self.mesh is None \
            else self._coll.widen(state.present)
        words = present.cpu().numpy().view(np.uint32)
        c = np.arange(self.capacity)
        return ((words[..., c // 32] >> (c % 32)) & 1).astype(bool)

    def list_committed(self, state: KafkaState, node: int) -> dict[int, int]:
        """Per-key committed offsets from the node's LOCAL cache (on a
        mesh the owner rank's row, through one all-reduce)."""
        if self.mesh is None:
            lc = state.local_committed[node]
        else:
            loc = node - self._row0
            row = (state.local_committed[loc] if 0 <= loc < self._block
                   else torch.zeros(self.n_keys, dtype=torch.int32,
                                    device=self.device))
            lc = self._coll.reduce_sum(row)
        lc = lc.cpu().numpy()
        (nz,) = np.nonzero(lc > 0)
        return {int(k): int(lc[k]) for k in nz}

    def lin_kv(self, state: KafkaState) -> dict[int, int]:
        """The shared lin-kv cells (key -> value): after sends, the
        allocator's next offset (replicated on a mesh)."""
        c = state.kv_val.cpu().numpy()
        return {k: int(c[k]) for k in range(self.n_keys) if c[k] > 0}


def _poll_words(words, log_vals, keys, from_off, cap: int):
    """The poll's answers from the queried (node, key) presence words
    (Q, Wc): each slot's offset where it is present and at least the
    query's from-offset (else -1), and its value (else 0)."""
    offs = torch.arange(1, cap + 1, dtype=torch.int32, device=words.device)
    slots = (offs - 1).to(torch.int64)
    pres = ((words[:, slots // 32] >> (slots % 32).to(torch.int32)) & 1) > 0
    sel = pres & (offs[None, :] >= from_off[:, None])
    return (torch.where(sel, offs[None, :], -1),
            torch.where(sel, log_vals[keys], 0))


def _build_batch_round(sim: KafkaSim):
    """One scenario's round for the scenario batches (:mod:`.scenario`),
    which run each Kafka scenario on its own sim under its own plan:
    ``rnd(state, send_key, send_val, tel=None, tel_spec=None) -> (state,
    tel)`` takes one (N, S) send batch, commit-free, in place
    (:meth:`KafkaSim.run_fused`), recording the telemetry row when given
    a ring (:meth:`KafkaSim.run_observed`).  The batches build their
    sims without a mesh (a rank runs whole scenarios); a mesh sim's round
    is its own collective one."""
    def rnd(state: KafkaState, send_key, send_val, tel=None, tel_spec=None):
        sk, sv = send_key[None], send_val[None]
        if tel is None:
            return sim.run_fused(state, sk, sv), None
        return sim.run_observed(state, tel, tel_spec, sk, sv, donate=True)
    return rnd


def _batch_converged(state: KafkaState, member=None,
                     first: int = 0) -> torch.Tensor:
    """() bool on the device: every node's presence identical; with
    ``member`` ((N,) bool) the member rows equal the first member's, row
    ``first`` (a host int, so the check makes no host sync)."""
    if member is None:
        return (state.present == state.present[:1]).all()
    ok = state.present == state.present[first][None]
    return (ok | ~member[:, None, None]).all()


def audit_contracts():
    """The program audit's contracts: ROADMAP.md Queue A item 14."""
    raise _unported("kafka.audit_contracts", 14)
