"""txn-rw-register (Gossip Glomers challenge 6) on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/txn.py's single-device ``TxnSim``.

Each node runs one client issuing a seeded sequence of transactions; a
transaction is a fixed batch of ``ops_per_txn`` read / write operations
over distinct keys, staged on the host (:func:`stage_txn_ops`, the
reference's numpy loop, draw for draw).  A :class:`.traffic.TrafficPlan`
drives arrivals: a node's next transaction slot opens when its client's
seeded arrival coin fires.

**Wound-or-die by CAS on per-key versions.**  Every round each live node
with an open transaction claims its keys at priority ``issue_round * N +
node`` (int32, wrapping as the reference's does): older transactions
outrank younger ones, the node id breaks ties.  A per-key minimum finds
each key's best claimant, and a transaction commits iff it holds all its
keys; the winners' writes land through the version CAS
(:func:`.kvstore.cas_ver_apply_at`, the O(K) form of the reference's
``cas_ver_apply``).  Losers keep their issue stamp and retry next round.
Transactions serialize by ``(commit_round, node)``, which
:func:`..harness.checkers.check_txn_serializable` certifies on the host.

**Faults compose.**  A :class:`.faults.FaultPlan` gates liveness (a down
node's transaction stalls and keeps its stamp) and per-round KV reach
(the ``kv_drop`` coins); ``kv_amnesia=True`` wipes a restarting owner's
registers through the node amnesia coin, which resets versions, so a
later commit re-installs an already committed (key, version) pair and the
checker names the lost update.  Dup streams are refused
(:func:`.kvstore.reject_dup_stream`).  Ledger: charge at send, every
attempt pays ``4 * ops_per_txn`` messages (a read and a CAS round trip an
op).

One round is a few PyTorch ops (the amnesia wipe, liveness, the arrival
coins), the two kernels :func:`.kernels.txn_claim` (each key's best
claim, the attempts) and :func:`.kernels.txn_commit` (the winner test,
the reads, the slot records and write requests, the node counters), and
the version CAS over the K keys: no host sync.  ``t`` is a host int and
``msgs`` a 0-dim int64 holding the reference's uint32 ledger.  ``step``
and ``run`` leave the state passed in as it was (``run`` copies it once);
``run_fused`` updates it in place.

On a mesh (``TxnSim(mesh=)``, a :class:`..parallel.mesh.Mesh`) each
rank holds its block of every node-axis leaf (:func:`ops_specs`,
:meth:`TxnSim._state_spec`: the KV rows, ``arrived``, ``cur``, ``issue``,
the stamps, the records and the staged ops), and ``t`` and ``msgs`` stay
whole and equal on every rank.  A round runs the kernels in their block
forms over the rank's rows with global ids: the claim's priorities
``issue * N + node`` over the sim's N, its ``best`` then one
``reduce_min``; the (value, version) view of every key from its owner's
rows (:func:`.kvstore.rows_view_block`, one ``reduce_sum``), which the
commit reads in place of the local rows; the (3, K) write requests and
the attempts packed into one ``reduce_sum``; the version CAS on the owner
ranks' rows (:func:`.kvstore.block_slots`).  All-reduces only: no
all-gather, no ppermute (the reference's ``txn/sharded-step`` contract).
``step``, ``run`` and ``run_fused`` take the whole cluster's operands
(the staged ops, made once and cut by each rank); :func:`history_of` and
:func:`final_registers` of a mesh state, given the mesh, are collective
calls that give every rank the whole answer.

On a hierarchical ``("hosts", "nodes")`` mesh the node blocks are the
flat mesh's and the reductions run the engine's two-level circuits,
``dcn_mode`` scheduling their hosts level (``sync`` or ``pipelined``;
``stale:k`` refuses: wound-or-die needs the current round's claims).  A
``words`` mesh refuses.  Not ported yet, and raising: the program audit
(ROADMAP.md Queue A item 14: ``audit_run_program``, ``audit_contracts``).
The scenario batches (:mod:`.scenario`) step each scenario through
``_build_batch_round``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import faults, kernels, kvstore, traffic
from .engine import (check_mesh, collectives, fori_rounds, local_block,
                     refuse_words, resolve_dcn_mode,
                     node_index, node_shards,
                     resolve_device)
from .faults import MASK32

# the reference's methods that this port leaves out, by ROADMAP.md Queue
# A item
_UNPORTED_METHODS = {"audit_run_program": 14}

#: a leaf cut along the node axis (its first), as the reference's
#: ``P(axes, ...)``; ``()`` keeps a leaf whole on every rank, as ``P()``
NODE = "nodes"


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md Queue A item {item})")


class TxnOps(NamedTuple):
    """The staged per-node transaction programs: slot ``(i, s)`` is node
    i's s-th transaction."""

    keys: torch.Tensor    # (N, T, O) int32, distinct within a txn
    write: torch.Tensor   # (N, T, O) bool, the op is a write
    wval: torch.Tensor    # (N, T, O) int32, the value written


class TxnState(NamedTuple):
    rows: kvstore.KVRows          # (N, cap) key registers
    arrived: torch.Tensor         # (N,) int32, txns offered so far
    cur: torch.Tensor             # (N,) int32, the open slot
    issue: torch.Tensor           # (N,) int32, the open slot's first
                                  #   attempt round (-1: fresh)
    issue_round: torch.Tensor     # (N, T) int32, provenance stamp
    commit_round: torch.Tensor    # (N, T) int32, -1 until committed
    op_ver: torch.Tensor          # (N, T, O) int32, version read (reads)
                                  #   or installed (writes)
    op_val: torch.Tensor          # (N, T, O) int32, value read / written
    t: int                        # round counter
    msgs: torch.Tensor            # () int64, a uint32 ledger


def ops_specs(axes="nodes") -> TxnOps:
    """The reference's shard specs of the ops, one per leaf: every leaf
    is cut along its node axis to a rank's block (``(axes, None,
    None)``); :func:`..engine.local_block` reads them."""
    node3 = (axes, None, None)
    return TxnOps(node3, node3, node3)


@functools.lru_cache(maxsize=4)
def _staged(n: int, t_dim: int, o: int, n_keys: int,
            seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's staging loop, cached (it is a pure function of its
    arguments and costs seconds at 65,536 nodes); read-only arrays."""
    rng = np.random.default_rng(seed)
    if o > n_keys:
        raise ValueError("ops_per_txn must be <= n_keys (distinct "
                         "keys within a transaction)")
    keys = np.zeros((n, t_dim, o), np.int32)
    for i in range(n):
        for s in range(t_dim):
            keys[i, s] = rng.choice(n_keys, size=o, replace=False)
    write = rng.random((n, t_dim, o)) < 0.5
    write[:, :, 0] = True
    txn_id = (np.arange(n)[:, None] * t_dim
              + np.arange(t_dim)[None, :])
    wval = (1 + txn_id[:, :, None] * o
            + np.arange(o)[None, None, :]).astype(np.int32)
    for a in (keys, write, wval):
        a.flags.writeable = False
    return keys, write, wval


def stage_txn_ops(n_nodes: int, txns_per_node: int, ops_per_txn: int,
                  n_keys: int, seed: int,
                  device: str | torch.device = "cpu") -> TxnOps:
    """The seeded workload, staged on the host (the reference's numpy
    loop, so the arrays equal its for every seed): per slot
    ``ops_per_txn`` distinct keys, about half writes (op 0 always, so
    every commit moves the version graph), and write values that are
    globally unique ids ``1 + txn_id * O + op``."""
    keys, write, wval = _staged(n_nodes, txns_per_node, ops_per_txn,
                                n_keys, seed)
    return TxnOps(*(torch.from_numpy(a.copy()).to(device)
                    for a in (keys, write, wval)))


class TxnSim:
    """Round-synchronous txn-rw-register simulator over the device KV
    rows (:mod:`.kvstore`)."""

    def __init__(self, n_nodes: int, n_keys: int, *,
                 txns_per_node: int = 4, ops_per_txn: int = 2,
                 tspec: "traffic.TrafficSpec | None" = None,
                 rate: float = 0.5, until: int | None = None,
                 mesh=None, seed: int = 0, workload_seed: int = 0,
                 fault_plan: "faults.FaultPlan | None" = None,
                 kv_amnesia: bool = False, dcn_mode: "str | None" = None,
                 ops: "TxnOps | None" = None,
                 device: str | torch.device | None = None) -> None:
        """The reference's arguments: ``tspec`` the arrival driver, one
        client per node with ``ops_per_client == txns_per_node`` (None: a
        Poisson spec from ``rate`` / ``until`` / ``workload_seed``, which
        also seeds :func:`stage_txn_ops`); ``seed`` the KV layout's.
        ``device``: where the state lives (default CUDA; raises if there
        is none).  ``mesh``: a :class:`..parallel.mesh.Mesh`, this rank
        running its block of the nodes on ``mesh.device`` (N must divide
        evenly; every rank calls every method in the same order).
        ``ops``: the whole cluster's staged ops (:func:`stage_txn_ops`'
        arrays, numpy or tensors, for these arguments) to use in place of
        staging them here, so that the ranks of a mesh need not each run
        the host loop; a rank cuts its block.  ``dcn_mode``: the hosts
        level's schedule on a hierarchical mesh
        (:func:`.engine.resolve_dcn_mode`; None defers to the env);
        ``stale:k`` refuses."""
        kvstore.reject_dup_stream(fault_plan, "TxnSim")
        if fault_plan is not None and fault_plan.n_nodes != n_nodes:
            raise ValueError(
                f"FaultPlan is for {fault_plan.n_nodes} nodes, "
                f"sim has {n_nodes}")
        if tspec is None:
            tspec = traffic.TrafficSpec(
                n_nodes=n_nodes, n_clients=n_nodes,
                ops_per_client=txns_per_node,
                until=(4 * txns_per_node if until is None else until),
                rate=rate, seed=workload_seed)
        if tspec.n_clients != n_nodes:
            raise ValueError("txn workload runs ONE client per node "
                             f"(n_clients={tspec.n_clients}, "
                             f"n_nodes={n_nodes})")
        if tspec.ops_per_client != txns_per_node:
            raise ValueError(
                f"tspec.ops_per_client={tspec.ops_per_client} must "
                f"equal txns_per_node={txns_per_node}")
        if mesh is not None:
            check_mesh(mesh)
            refuse_words(mesh, "TxnSim")
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
                f"dcn_mode={self._dcn.label()!r}: txn has no "
                "certified staleness semantics — the wound-or-die "
                "version-CAS fold (reduce_min over claimant stamps) "
                "must see the current round's claims or wounded "
                "transactions commit; run sync or pipelined")
        self.device = resolve_device(device)
        self.mesh = mesh
        # this rank's rows: all of them off a mesh
        self._block = n_nodes if mesh is None else n_nodes // node_shards(mesh)
        self._row0 = 0 if mesh is None else node_index(mesh) * self._block
        self._coll = (None if mesh is None
                      else collectives(self._block, mesh, dcn=self._dcn))
        self.n_nodes = n_nodes
        self.n_keys = n_keys
        self.txns_per_node = txns_per_node
        self.ops_per_txn = ops_per_txn
        self.tspec = tspec
        self._tplan = tspec.compile()
        self.seed = seed
        self.workload_seed = workload_seed
        self.fault_plan = (None if fault_plan is None
                           else fault_plan.to(self.device))
        self.kv_amnesia = bool(kv_amnesia)
        self.layout = kvstore.make_layout(n_keys, n_nodes, seed=seed)
        self._slots = kvstore.key_slots(self.layout, self.device)
        # a rank's share of the store: the keys its rows own
        self._block_slots = kvstore.block_slots(
            self.layout, self._row0, self._block, self.device)
        if ops is None:
            ops = _staged(n_nodes, txns_per_node, ops_per_txn, n_keys,
                          workload_seed)
        shape = (n_nodes, txns_per_node, ops_per_txn)
        if any(tuple(x.shape) != shape for x in ops):
            raise ValueError(f"ops must be the whole cluster's {shape} "
                             "arrays")
        self.ops = TxnOps(*(
            local_block(x, spec, mesh, dtype=dt, device=self.device)
            for x, spec, dt in zip(ops, ops_specs(),
                                   (torch.int32, torch.bool, torch.int32))))
        self._row_ids = torch.arange(self._row0, self._row0 + self._block,
                                     dtype=torch.int32, device=self.device)

    def __getattr__(self, name: str):
        if name in _UNPORTED_METHODS:
            raise _unported(f"TxnSim.{name}", _UNPORTED_METHODS[name])
        raise AttributeError(name)

    def _state_spec(self) -> TxnState:
        """The reference's shard specs of the state, one per leaf: the
        KV rows and every (N, ...) leaf cut along the node axis to a
        rank's block, ``t`` and ``msgs`` whole (``()``)."""
        node, node2, node3 = (NODE,), (NODE, None), (NODE, None, None)
        return TxnState(
            rows=kvstore.KVRows(node2, node2), arrived=node, cur=node,
            issue=node, issue_round=node2, commit_round=node2, op_ver=node3,
            op_val=node3, t=(), msgs=())

    def init_state(self) -> TxnState:
        """The round-0 state (this rank's block of the node-axis leaves on
        a mesh, by :meth:`_state_spec`)."""
        n, t_dim, o = self.n_nodes, self.txns_per_node, self.ops_per_txn
        spec = self._state_spec()

        def full(shape, v, sp):
            if sp and sp[0] == NODE:
                shape = (self._block,) + shape[1:]
            return torch.full(shape, v, dtype=torch.int32,
                              device=self.device)

        return TxnState(
            rows=kvstore.init_rows(self.layout, self.device,
                                   rows=self._block),
            arrived=full((n,), 0, spec.arrived),
            cur=full((n,), 0, spec.cur), issue=full((n,), -1, spec.issue),
            issue_round=full((n, t_dim), -1, spec.issue_round),
            commit_round=full((n, t_dim), -1, spec.commit_round),
            op_ver=full((n, t_dim, o), -1, spec.op_ver),
            op_val=full((n, t_dim, o), -1, spec.op_val),
            t=0, msgs=torch.zeros((), dtype=torch.int64,
                                  device=self.device))

    # -- round -------------------------------------------------------------

    def _round(self, state: TxnState) -> TxnState:
        """One round, in place on ``state``'s node counters, records and
        KV rows (a restarting owner's wipe makes new rows): the amnesia
        wipe, liveness, the arrivals, the claim, the commit and the
        version CAS of the winners' write requests, the charge-at-send
        ledger.  On a mesh the module docstring's three all-reduces join
        the ranks' blocks."""
        t = state.t
        ids = self._row_ids
        rows = state.rows
        plan = self.fault_plan
        arr = traffic.arrive(self._tplan, t, ids)
        arrived = torch.clamp(state.arrived + arr.to(torch.int32),
                              max=self.txns_per_node)
        active = state.cur < arrived
        if plan is not None:
            if self.kv_amnesia:
                rows = kvstore.rows_wipe(rows, plan, t, ids)
            active = active & faults.node_up(plan, t, ids) \
                & ~faults.kv_drop(plan, t, ids)
        ops = self.ops
        k_dim = self.n_keys
        blk = dict(row0=self._row0, n_total=self.n_nodes)
        best, attempts = kernels.txn_claim(ops.keys, state.cur, state.issue,
                                           active, t=t, n_keys=k_dim, **blk)
        records = (state.op_ver, state.op_val, state.commit_round,
                   state.issue_round)
        if self.mesh is None:
            req = kernels.txn_commit(
                best, ops.keys, ops.write, ops.wval, state.cur, state.issue,
                active, self._slots.owner, self._slots.slot, rows.vals,
                rows.vers, *records, t=t)
            slots, on, ver, val = (self._slots, req[0] > 0, req[2], req[1])
        else:
            coll = self._coll
            best = coll.reduce_min(best)
            view = kvstore.rows_view_block(rows, self._block_slots, k_dim,
                                           coll.reduce_sum)
            part = kernels.txn_commit(
                best, ops.keys, ops.write, ops.wval, state.cur, state.issue,
                active, None, None, None, None, *records, t=t, view=view,
                **blk)
            g = coll.reduce_sum(torch.cat([part.reshape(-1), attempts]))
            req, attempts = g[:3 * k_dim].view(3, k_dim), g[3 * k_dim:]
            # the requests land on the keys this rank's rows own
            slots, keys = self._block_slots
            on, ver, val = (req[0] > 0)[keys], req[2][keys], req[1][keys]
        rows = kvstore.cas_ver_apply_at(rows, slots, on, ver, val,
                                        donate=True)
        msgs = (state.msgs + attempts[0].to(torch.int64)
                * (4 * self.ops_per_txn)) & MASK32
        return state._replace(rows=rows, arrived=arrived, t=t + 1,
                              msgs=msgs)

    @staticmethod
    def _copy(state: TxnState) -> TxnState:
        """The state with fresh copies of what the rounds update in
        place."""
        return state._replace(
            rows=kvstore.KVRows(state.rows.vals.clone(),
                                state.rows.vers.clone()),
            cur=state.cur.clone(), issue=state.issue.clone(),
            issue_round=state.issue_round.clone(),
            commit_round=state.commit_round.clone(),
            op_ver=state.op_ver.clone(), op_val=state.op_val.clone())

    def step(self, state: TxnState) -> TxnState:
        return self._round(self._copy(state))

    def run(self, state: TxnState, n_rounds: int) -> TxnState:
        return fori_rounds(self._round, self._copy(state), n_rounds)

    def run_fused(self, state: TxnState, n_rounds: int) -> TxnState:
        """:meth:`run` in place: the state passed in is updated and must
        not be used again."""
        return fori_rounds(self._round, state, n_rounds)


# -- host-side extraction ------------------------------------------------


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _whole(mesh, *xs) -> list[np.ndarray]:
    """The leaves as numpy: on a mesh every rank's block, gathered (a
    collective)."""
    if mesh is not None:
        xs = [mesh.all_gather(x) for x in xs]
    return [_np(x) for x in xs]


def history_of(state: TxnState, ops: TxnOps, mesh=None) -> list[dict]:
    """The recorded transaction history (the reference's): one entry per
    started transaction slot (txn id ``node * T + slot``), its status,
    its issue and commit rounds and, committed, its per-op (kind, key,
    version, value) records.  ``mesh``: the mesh of a sharded state and
    its sim's ops, whose blocks every rank gathers (a collective call:
    every rank gets the whole history)."""
    cr, ir, ver, val, keys, write = _whole(
        mesh, state.commit_round, state.issue_round, state.op_ver,
        state.op_val, ops.keys, ops.write)
    n, t_dim = cr.shape
    hist = []
    for i in range(n):
        for s in range(t_dim):
            if ir[i, s] < 0 and cr[i, s] < 0:
                continue
            committed = cr[i, s] >= 0
            entry = {
                "id": int(i * t_dim + s), "node": int(i),
                "slot": int(s),
                "status": "committed" if committed else "open",
                "issue_round": int(ir[i, s]),
                "commit_round": int(cr[i, s]),
                "ops": []}
            if committed:
                for j in range(ver.shape[2]):
                    entry["ops"].append({
                        "kind": "w" if write[i, s, j] else "r",
                        "key": int(keys[i, s, j]),
                        "ver": int(ver[i, s, j]),
                        "val": int(val[i, s, j])})
            hist.append(entry)
    return hist


def final_registers(state: TxnState, layout: kvstore.KVLayout,
                    mesh=None) -> dict:
    """``{key: (value, version)}``: the store's final registers (on a
    ``mesh`` every rank's rows, gathered: a collective call)."""
    vals, vers = _whole(mesh, state.rows.vals, state.rows.vers)
    out = {}
    for key in range(layout.n_keys):
        i, c = int(layout.owner[key]), int(layout.slot[key])
        out[int(key)] = (int(vals[i, c]), int(vers[i, c]))
    return out


def state_from_numpy(state, device: str | torch.device) -> TxnState:
    """A port state from the reference's ``TxnState`` (or anything with
    its fields, ``rows`` with ``vals`` / ``vers``), its leaves read as
    numpy, so that both packages can go on from one mid-run state."""
    def i32(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    return TxnState(
        rows=kvstore.KVRows(i32(state.rows.vals), i32(state.rows.vers)),
        arrived=i32(state.arrived), cur=i32(state.cur),
        issue=i32(state.issue), issue_round=i32(state.issue_round),
        commit_round=i32(state.commit_round), op_ver=i32(state.op_ver),
        op_val=i32(state.op_val), t=int(state.t),
        msgs=torch.tensor(int(state.msgs) & MASK32, dtype=torch.int64,
                          device=device))


# -- scenario-batch hooks ------------------------------------------------


def _build_batch_round(sim: TxnSim):
    """One scenario's round for the scenario batches (:mod:`.scenario`),
    which run each txn scenario on its own sim under its own plan:
    ``rnd(state)`` steps once in place (:meth:`TxnSim.run_fused`)."""
    def rnd(state: TxnState) -> TxnState:
        return sim.run_fused(state, 1)
    return rnd


def _batch_converged(state: TxnState) -> torch.Tensor:
    """() bool on the device: every offered transaction committed (a
    rank's block of them on a mesh)."""
    return (state.cur >= state.arrived).all()


# -- not ported yet ------------------------------------------------------


def audit_contracts():
    """The program contracts: ROADMAP.md Queue A item 14."""
    raise _unported("txn.audit_contracts", 14)
