"""The device-resident ``lin-kv`` / ``seq-kv`` service on PyTorch: the
port of gossip_glomers_tpu/tpu_sim/kvstore.py.

Key ``k`` lives in exactly one row slot of an ``(N, cap)`` slab at
``[owner(k), slot(k)]``: the owner by a stateless hash (:func:`owner_of`,
the fault coins' ``_mix32`` family), the slot by rank among the owner's
keys (:func:`make_layout`).  Each slot is a (value, version) register; a
write bumps the version.

- :func:`rows_view` reads the store as a (2, K) (values, versions) view;
  :func:`cas_apply`, :func:`cas_ver_apply` and :func:`write_apply` apply
  a request batch of replicated (K,) vectors as masked updates of the
  owner rows.  These are the reference's slab forms (a scatter over the
  whole slab, then its ``reduce_sum``), held equal to it bit for bit.
- :func:`key_slots` precomputes, on the host, where each key lives.
  Since every key occupies exactly one slot, a batch can touch only
  those K slots: :func:`rows_view_at` (the view) gathers them and
  :func:`cas_apply_at` (the counter's and Kafka's CAS) and
  :func:`cas_ver_apply_at` (the txn round's version CAS) read and
  write them alone, O(K) on rows the caller donates; each equals its
  slab form on every layout :func:`make_layout` builds.  On the card the
  slab view of the counter's one key would be N atomic adds into one
  address.
- :func:`rows_wipe`: a restarting owner loses its rows through the same
  :func:`.faults.amnesia` coin as node state (``kv_amnesia=True``).
- :func:`stale_coin`: the seq-kv stale read as a seeded ``(seed, round,
  node)`` hash, with its numpy twin :func:`host_stale_coin`.
- :func:`reject_dup_stream`: a duplicated KV request stream would
  double-commit against the rows, so the device backend refuses one.

On a mesh the rows are node-sharded like every sim state
(:func:`init_rows` of a rank's ``rows``, the reference's ``rows_spec``):
:func:`block_slots` lists the keys a rank's block owns, the view
(:func:`rows_view_block`) is each rank's stacked partial through one
all-reduce, and a CAS (:func:`cas_apply_at` over the block's slots)
touches only the owner's rows.

Every update returns new tensors, and the rows of the state passed in
stay as they were, unless the caller donates them
(``cas_apply_at(..., donate=True)``).  The program contracts
(``audit_contracts``) have no PyTorch meaning yet: ROADMAP.md Queue A
item 14.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import faults
from .faults import MASK32

# distinct stream salts (the faults.py convention): routing and the
# seq-kv stale coin draw independent streams from the same seed
_SALT_ROUTE = 0x4B565F31      # "KV_1"
_SALT_STALE = 0x5EC4C0DE
_K_ROUTE = 0x27D4EB2F
_K_STALE_ID, _K_STALE_T = 0xC2B2AE35, 0x9E3779B9


class KVLayout(NamedTuple):
    """Host-side static key layout: ``key_at[i, c]`` is the key hosted at
    node i, slot c (-1 = empty)."""

    owner: np.ndarray     # (K,) int32 — owning node per key
    slot: np.ndarray      # (K,) int32 — row slot at the owner
    key_at: np.ndarray    # (N, cap) int32 — key per row slot, -1 empty
    n_keys: int
    n_nodes: int
    cap: int
    seed: int


class KVRows(NamedTuple):
    """The device store: one (value, version) register per key row."""

    vals: torch.Tensor    # (N, cap) int32
    vers: torch.Tensor    # (N, cap) int32


class KeySlots(NamedTuple):
    """Where each key of a :class:`KVLayout` lives, as (K,) int64 index
    tensors on the store's device (:func:`key_slots`)."""

    owner: torch.Tensor
    slot: torch.Tensor


def host_owner_of(keys: np.ndarray, n_nodes: int,
                  seed: int = 0) -> np.ndarray:
    """(K,) int32 — numpy twin of :func:`owner_of`."""
    x = (np.asarray(keys).astype(np.uint32) * np.uint32(_K_ROUTE)
         ^ np.uint32((seed ^ _SALT_ROUTE) & MASK32))
    return (faults._mix32_np(x) % np.uint32(n_nodes)).astype(np.int32)


def owner_of(keys: torch.Tensor, n_nodes: int,
             seed: int = 0) -> torch.Tensor:
    """(K,) int32 — owning node per key: a stateless ``_mix32`` hash,
    bit-identical to :func:`host_owner_of`."""
    x = (faults._mul32(keys.to(torch.int64) & MASK32, _K_ROUTE)
         ^ ((seed ^ _SALT_ROUTE) & MASK32))
    return (faults._mix32(x) % n_nodes).to(torch.int32)


def make_layout(n_keys: int, n_nodes: int, *, seed: int = 0,
                min_cap: int = 1) -> KVLayout:
    """The static layout of keys ``0..n_keys-1``: stateless-hash owners,
    per-owner slot ranks in key order, ``cap`` the most keys an owner
    holds (at least ``min_cap``)."""
    keys = np.arange(n_keys, dtype=np.int32)
    owner = host_owner_of(keys, n_nodes, seed)
    slot = np.zeros(n_keys, np.int32)
    counts = np.zeros(n_nodes, np.int32)
    for k in range(n_keys):
        slot[k] = counts[owner[k]]
        counts[owner[k]] += 1
    cap = max(int(min_cap), int(counts.max()) if n_keys else 0)
    key_at = np.full((n_nodes, cap), -1, np.int32)
    key_at[owner, slot] = keys
    return KVLayout(owner=owner, slot=slot, key_at=key_at,
                    n_keys=n_keys, n_nodes=n_nodes, cap=cap, seed=seed)


def init_rows(layout: KVLayout, device: str | torch.device = "cpu", *,
              rows: int | None = None) -> KVRows:
    """All-zero rows, ``vals`` and ``vers`` distinct buffers: every
    node's, or ``rows`` of them (a rank's block of a mesh)."""
    def z():
        return torch.zeros((layout.n_nodes if rows is None else rows,
                            layout.cap), dtype=torch.int32, device=device)

    return KVRows(vals=z(), vers=z())


def key_slots(layout: KVLayout,
              device: str | torch.device = "cpu") -> KeySlots:
    """Each key's (owner, slot) as index tensors on ``device``."""
    return KeySlots(
        owner=torch.from_numpy(layout.owner.astype(np.int64)).to(device),
        slot=torch.from_numpy(layout.slot.astype(np.int64)).to(device))


def block_slots(layout: KVLayout, row0: int, block: int,
                device: str | torch.device = "cpu"
                ) -> tuple[KeySlots, torch.Tensor]:
    """The keys that the rows ``[row0, row0 + block)`` own (a rank's
    block of a mesh): ``(slots, keys)``, their (owner - row0, slot) in the
    block's rows and their (K_b,) int64 key ids, in key order."""
    own = np.flatnonzero((layout.owner >= row0)
                         & (layout.owner < row0 + block))
    return (KeySlots(
        owner=torch.from_numpy((layout.owner[own] - row0).astype(
            np.int64)).to(device),
        slot=torch.from_numpy(layout.slot[own].astype(np.int64)).to(device)),
        torch.from_numpy(own.astype(np.int64)).to(device))


def rows_view_block(rows: KVRows, block: tuple[KeySlots, torch.Tensor],
                    n_keys: int, reduce_sum) -> torch.Tensor:
    """:func:`rows_view` of a rank's block of the rows on a mesh: (2, K)
    int32, each key's (value, version) from its owner, zeros from the
    other ranks' blocks, through one ``reduce_sum`` of the stacked
    partial."""
    slots, keys = block
    part = torch.zeros((2, n_keys), dtype=torch.int32,
                       device=rows.vals.device)
    part[:, keys] = rows_view_at(rows, slots)
    return reduce_sum(part)


# -- slab forms (the reference's) ------------------------------------------


def _key_index(key_at: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    occ = key_at >= 0
    return occ, torch.where(occ, key_at, 0).to(torch.int64)


def rows_view(rows: KVRows, key_at: torch.Tensor, n_keys: int,
              reduce_sum) -> torch.Tensor:
    """(2, K) int32 (values row 0, versions row 1): every occupied slot
    scattered into the key axis, then ``reduce_sum`` (the identity on
    one device)."""
    occ, idx = _key_index(key_at)
    idx = idx.reshape(-1)

    def scatter(x):
        out = torch.zeros((n_keys,), dtype=torch.int32, device=x.device)
        return out.index_add_(0, idx, torch.where(occ, x, 0).reshape(-1))

    return reduce_sum(torch.stack([scatter(rows.vals), scatter(rows.vers)]))


def _masked_update(rows: KVRows, hit: torch.Tensor, val: torch.Tensor,
                   idx: torch.Tensor) -> KVRows:
    return KVRows(vals=torch.where(hit, val[idx], rows.vals),
                  vers=torch.where(hit, rows.vers + 1, rows.vers))


def cas_apply(rows: KVRows, key_at: torch.Tensor, on: torch.Tensor,
              frm: torch.Tensor, to: torch.Tensor) -> KVRows:
    """CAS as a masked compare-update: for every key ``k`` with ``on[k]``
    whose row value equals ``frm[k]`` the value becomes ``to[k]`` and the
    version bumps; misses leave the row as it was."""
    occ, idx = _key_index(key_at)
    hit = occ & on[idx] & (rows.vals == frm[idx])
    return _masked_update(rows, hit, to, idx)


def cas_ver_apply(rows: KVRows, key_at: torch.Tensor, on: torch.Tensor,
                  ver: torch.Tensor, val: torch.Tensor) -> KVRows:
    """Version-compare CAS: write ``val[k]`` iff the row's version still
    equals ``ver[k]``."""
    occ, idx = _key_index(key_at)
    hit = occ & on[idx] & (rows.vers == ver[idx])
    return _masked_update(rows, hit, val, idx)


def write_apply(rows: KVRows, key_at: torch.Tensor, on: torch.Tensor,
                val: torch.Tensor) -> KVRows:
    """Unconditional masked write (seq-kv ``write``): set and bump."""
    occ, idx = _key_index(key_at)
    return _masked_update(rows, occ & on[idx], val, idx)


# -- the O(K) forms over the occupied slots ---------------------------------


def rows_view_at(rows: KVRows, slots: KeySlots) -> torch.Tensor:
    """:func:`rows_view` as a gather of the K occupied slots: (2, K)
    int32, values row 0, versions row 1."""
    at = (slots.owner, slots.slot)
    return torch.stack([rows.vals[at], rows.vers[at]])


def cas_apply_at(rows: KVRows, slots: KeySlots, on: torch.Tensor,
                 frm: torch.Tensor, to: torch.Tensor, *,
                 donate: bool = False) -> KVRows:
    """:func:`cas_apply` over the K occupied slots.  ``donate``: write
    the K slots into ``rows``' own tensors and return them, O(K); else
    into copies of the (N, cap) slabs, O(N cap)."""
    at = (slots.owner, slots.slot)
    hit = on & (rows.vals[at] == frm)
    vals, vers = (rows.vals, rows.vers) if donate else \
        (rows.vals.clone(), rows.vers.clone())
    vals[at] = torch.where(hit, to, vals[at])
    vers[at] = vers[at] + hit.to(torch.int32)
    return KVRows(vals=vals, vers=vers)


def cas_ver_apply_at(rows: KVRows, slots: KeySlots, on: torch.Tensor,
                     ver: torch.Tensor, val: torch.Tensor, *,
                     donate: bool = False) -> KVRows:
    """:func:`cas_ver_apply` over the K occupied slots (the txn round's
    version CAS), in place on ``rows`` with ``donate`` as
    :func:`cas_apply_at`."""
    at = (slots.owner, slots.slot)
    hit = on & (rows.vers[at] == ver)
    vals, vers = (rows.vals, rows.vers) if donate else \
        (rows.vals.clone(), rows.vers.clone())
    vals[at] = torch.where(hit, val, vals[at])
    vers[at] = vers[at] + hit.to(torch.int32)
    return KVRows(vals=vals, vers=vers)


# -- faults and staleness ----------------------------------------------------


def wipe_rows(rows: KVRows, wipe: torch.Tensor) -> KVRows:
    """Zero the rows of the owners where the (N,) bool ``wipe`` holds."""
    w = wipe[:, None]
    return KVRows(vals=torch.where(w, 0, rows.vals),
                  vers=torch.where(w, 0, rows.vers))


def rows_wipe(rows: KVRows, plan: faults.FaultPlan, t: int,
              row_ids: torch.Tensor) -> KVRows:
    """Crash amnesia over KV rows: an owner restarting at round ``t``
    loses its registers, by the :func:`.faults.amnesia` coin that wipes
    node state."""
    return wipe_rows(rows, faults.amnesia(plan, t, row_ids))


def stale_key(seed: int, t: int) -> int:
    """The uint32 term of round ``t`` that :func:`stale_coin` XORs into
    each node's id product."""
    return ((t & MASK32) * _K_STALE_T & MASK32) ^ (seed & MASK32) \
        ^ _SALT_STALE


def stale_coin(seed: int, t: int, ids: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32): the per-(round, node) stale-read coin; a read
    is served stale iff the coin is below ``stale_num`` (and the reader is
    behind).  Bit-identical to :func:`host_stale_coin`."""
    return faults._mix32(faults._mul32(ids.to(torch.int64) & MASK32,
                                       _K_STALE_ID) ^ stale_key(seed, t))


def host_stale_coin(seed: int, t: int, node) -> np.ndarray:
    """numpy twin of :func:`stale_coin`."""
    t_term = np.uint32((int(t) * _K_STALE_T) & MASK32)
    x = (np.asarray(node, np.int64).astype(np.uint32)
         * np.uint32(_K_STALE_ID)
         ^ t_term ^ np.uint32(seed & MASK32) ^ np.uint32(_SALT_STALE))
    return faults._mix32_np(x)


def stale_num_of(prob: float) -> int:
    """Probability -> uint32 coin threshold (the faults.py rate
    convention)."""
    return faults._rate_to_num(prob)


def reject_dup_stream(fault_plan, where: str) -> None:
    """Refuse a plan with a dup stream on the device backend: a
    duplicated KV request would re-apply a CAS or write against the
    authoritative rows (a double commit)."""
    if fault_plan is not None and int(fault_plan.dup_num) > 0:
        raise ValueError(
            f"{where}: kv_backend='device' refuses dup streams "
            "(dup_rate > 0): a duplicated KV request re-applied against "
            "the device rows double-commits; use dup_rate=0 with the "
            "device backend")
