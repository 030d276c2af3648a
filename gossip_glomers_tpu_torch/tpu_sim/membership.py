"""Elastic resizing on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/membership.py — resize a run's padded node
axis at a checkpoint boundary.

Membership events (join / leave) compile to two ``(N,)`` columns of the
:class:`.faults.FaultPlan` and fold into every liveness gate.  A resize
is expressible two ways, and this module is the bridge between them:

- in place, at a fixed capacity: a grow is a block of padded rows that
  JOIN at the resize round (they enter empty and catch up through the
  workload's anti-entropy), a shrink a block of rows that LEAVE;
- across a checkpoint boundary, at a new capacity:
  :func:`restore_resized` reloads a mid-run checkpoint (the fault spec
  rides its meta) into a larger or smaller node axis.  Grown rows enter
  empty and join at the boundary round; rows cut away must already be
  non-members (:func:`resize_spec` names any still-member row).  The
  continuation spec it returns is the spec the in-place form runs at the
  new capacity from round 0, so the two forms are bit-exact twins for
  capacity-independent dynamics (broadcast on ``full``, the counter's
  shared KV): :mod:`..harness.membership` holds them to it.

Re-homing: key ownership is a pure function of ``(key, n_nodes, seed)``,
so a resize moves exactly the keys whose hash changes home.
:func:`rehomed_keys` (host) and :func:`rehomed_mask` (device) compute
that diff independently; :func:`apply_rehoming` carries the KV registers
across the boundary on the rows' device.

The device functions here are a few torch ops over at most K keys or N
rows (no kernel).  Not ported yet, and raising: the program contracts
(:func:`audit_contracts`, ROADMAP.md Queue A item 14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import checkpoint, faults, kvstore
from .engine import resolve_device

# Which fields of each sim state carry the padded node axis, and on which
# dimension: the only fields a resize reshapes (the reference's map: axis
# 0, which is the node axis of the node-major layouts only; a words-major
# (W, N) BroadcastState is padded on its words axis, as the reference
# pads it: ROADMAP.md Queue C)
_NODE_AXIS: dict[str, dict[str, int]] = {
    "BroadcastState": {"received": 0, "frontier": 0},
    "CounterState": {"pending": 0, "cached": 0},
    "KafkaState": {"present": 0, "local_committed": 0, "origin_bits": 0},
}
# fields a resize refuses to carry, with the reason
_REJECT_LEAVES: dict[str, dict[str, str]] = {
    "BroadcastState": {
        "history": "the per-edge delay ring holds PAST payload blocks "
                   "at the old capacity — resize campaigns run "
                   "1-hop (delays=None)"},
    "CounterState": {
        "rows": "device KV rows re-home by hash, not by pad/truncate "
                "— carry them with membership.apply_rehoming"},
    "KafkaState": {
        "rows": "device KV rows re-home by hash, not by pad/truncate "
                "— carry them with membership.apply_rehoming"},
}


def _replace(state, **kw):
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **kw)
    return state._replace(**kw)


# -- device evaluators ---------------------------------------------------


def member_census(plan: faults.FaultPlan, t: int, row_ids,
                  reduce_sum=None) -> torch.Tensor:
    """() int32: how many rows are members at round ``t``
    (:func:`.faults.member_at` over ``row_ids``, summed); ``reduce_sum``
    is the identity off a mesh."""
    n = faults.member_at(plan, t, row_ids).sum(dtype=torch.int32)
    return n if reduce_sum is None else reduce_sum(n)


def rehomed_mask(n_keys: int, n_from: int, n_to: int, seed: int = 0, *,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """(K,) bool on ``device`` (CUDA unless given): which keys change
    owner across an ``n_from -> n_to`` resize, from the routing hash
    (:func:`.kvstore.owner_of`); equal to :func:`rehomed_keys`."""
    keys = torch.arange(n_keys, dtype=torch.int32,
                        device=resolve_device(device))
    return (kvstore.owner_of(keys, n_from, seed)
            != kvstore.owner_of(keys, n_to, seed))


# -- the resize boundary -------------------------------------------------


def resize_spec(spec: faults.NemesisSpec, n_to: int,
                resize_round: int) -> faults.NemesisSpec:
    """The continuation spec at the new capacity, and equally the
    straight-through twin's spec.  Grow: rows ``[n, n_to)`` join at
    ``resize_round``.  Shrink: every dropped row must already be a
    non-member at the boundary (a still-member row is named); crash
    windows and membership events on dropped rows are filtered out, and
    the loss / dup horizons are made explicit."""
    n = spec.n_nodes
    if resize_round < 1:
        raise ValueError(
            f"resize_round must be >= 1, got {resize_round} (round-0 "
            "members are the founding set; a boundary needs a past)")
    if n_to == n:
        raise ValueError(f"resize to the same capacity ({n})")
    if n_to > n:
        joined = tuple(range(n, n_to))
        return dataclasses.replace(
            spec, n_nodes=n_to,
            join=spec.join + ((resize_round, joined),),
            loss_until=spec._until(spec.loss_until, spec.loss_rate),
            dup_until=spec._until(spec.dup_until, spec.dup_rate))
    members = spec.host_members(resize_round)
    alive = np.nonzero(members[n_to:])[0] + n_to
    if alive.size:
        raise ValueError(
            f"cannot shrink {n} -> {n_to} at round {resize_round}: "
            f"rows {alive.tolist()} are still members — schedule "
            "their leave before the boundary (a leave drains; a "
            "truncation would destroy live acked state)")

    def keep(events):
        out = []
        for first, ns in events:
            ns = tuple(i for i in ns if i < n_to)
            if ns:
                out.append((first, ns))
        return tuple(out)

    crash = []
    for s, e, ns in spec.crash:
        ns = tuple(i for i in ns if i < n_to)
        if ns:
            crash.append((s, e, ns))
    return faults.NemesisSpec(
        n_nodes=n_to, seed=spec.seed, crash=tuple(crash),
        loss_rate=spec.loss_rate,
        loss_until=spec._until(spec.loss_until, spec.loss_rate),
        dup_rate=spec.dup_rate,
        dup_until=spec._until(spec.dup_until, spec.dup_rate),
        join=keep(spec.join), leave=keep(spec.leave))


def resize_state(state, n_to: int):
    """Map one sim state's padded node axis to ``n_to``: the declared
    node-axis fields (``_NODE_AXIS``) pad with zero rows on their own
    device (grow) or are cut into a fresh contiguous tensor (shrink);
    every other field carries over.  Fields that cannot be resized are
    refused with the reason (``_REJECT_LEAVES``).  The safety of a shrink
    is :func:`resize_spec`'s check, which :func:`restore_resized` runs
    first."""
    cls = type(state).__name__
    axes = _NODE_AXIS.get(cls)
    if axes is None:
        raise ValueError(
            f"no node-axis resize map for {cls}: supported states "
            f"are {sorted(_NODE_AXIS)}")
    for fname, why in _REJECT_LEAVES.get(cls, {}).items():
        if getattr(state, fname, None) is not None:
            raise ValueError(
                f"{cls}.{fname} cannot cross a resize boundary: {why}")
    n_from = None
    repl = {}
    for fname, ax in axes.items():
        leaf = getattr(state, fname, None)
        if leaf is None:
            continue
        if n_from is None:
            n_from = int(leaf.shape[ax])
        elif int(leaf.shape[ax]) != n_from:
            raise ValueError(
                f"{cls}.{fname} has node axis {leaf.shape[ax]}, "
                f"expected {n_from} — state leaves disagree on the "
                "padded capacity")
        if n_to > n_from:
            pad_shape = list(leaf.shape)
            pad_shape[ax] = n_to - n_from
            leaf = torch.cat([leaf, leaf.new_zeros(pad_shape)], dim=ax)
        elif n_to < n_from:
            leaf = leaf.narrow(ax, 0, n_to).clone(
                memory_format=torch.contiguous_format)
        repl[fname] = leaf
    if n_from is None:
        raise ValueError(f"{cls} has no node-axis leaves to resize")
    return _replace(state, **repl)


def restore_resized(path: str, state_cls: type, n_to: int, *,
                    device: str | torch.device | None = None):
    """Reload a mid-run checkpoint into a node axis of ``n_to`` rows on
    ``device`` (CUDA unless given).  Returns ``(state, spec, meta)``: the
    resized state (:func:`resize_state`) and the continuation spec
    (:func:`resize_spec`, the boundary round the checkpointed ``t``).
    The checkpoint must carry its fault spec (``checkpoint.save(...,
    fault_spec=spec)``): without it the resize has no membership ground
    truth and is refused."""
    state, meta = checkpoint.restore(path, state_cls, device=device)
    spec = checkpoint.fault_spec_from_meta(meta)
    if spec is None:
        raise ValueError(
            "checkpoint carries no fault_spec in its meta: an elastic "
            "resize re-derives liveness and membership at the new "
            "capacity from the spec — pass fault_spec= to "
            "checkpoint.save at the boundary")
    spec2 = resize_spec(spec, n_to, int(state.t))
    return resize_state(state, n_to), spec2, meta


# -- KV re-homing --------------------------------------------------------


def rehomed_keys(n_keys: int, n_from: int, n_to: int, *,
                 seed: int = 0) -> np.ndarray:
    """(M,) int32 host twin of :func:`rehomed_mask`: the sorted ids of
    the keys whose owner changes across the resize
    (:func:`.kvstore.host_owner_of`)."""
    keys = np.arange(n_keys, dtype=np.int32)
    moved = (kvstore.host_owner_of(keys, n_from, seed)
             != kvstore.host_owner_of(keys, n_to, seed))
    return keys[moved]


def apply_rehoming(rows: kvstore.KVRows, old: kvstore.KVLayout,
                   new: kvstore.KVLayout) -> kvstore.KVRows:
    """Carry the device KV registers across a resize on the rows' device:
    one gather of every key's (value, version) at its old ``(owner,
    slot)``, one scatter at its new one.  The moved set is exactly
    :func:`rehomed_keys`; an unmoved key lands back in its old slot."""
    if old.n_keys != new.n_keys:
        raise ValueError(
            f"layouts disagree on the key space: {old.n_keys} vs "
            f"{new.n_keys}")
    if old.seed != new.seed:
        raise ValueError(
            f"layouts disagree on the routing seed: {old.seed} vs "
            f"{new.seed} — re-homing is the CAPACITY diff only")
    dev = rows.vals.device

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    oo, os_, no, ns = idx(old.owner), idx(old.slot), idx(new.owner), \
        idx(new.slot)
    out = []
    for x in (rows.vals, rows.vers):
        y = torch.zeros((new.n_nodes, new.cap), dtype=torch.int32,
                        device=dev)
        y[no, ns] = x[oo, os_]
        out.append(y)
    return kvstore.KVRows(vals=out[0], vers=out[1])


# -- program contracts ---------------------------------------------------


def audit_contracts():
    """The membership layer's program contracts: ROADMAP.md Queue A item
    14."""
    raise NotImplementedError("membership.audit_contracts is not ported to "
                              "PyTorch yet (ROADMAP.md Queue A item 14)")
