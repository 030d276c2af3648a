"""Causal provenance on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/provenance.py — first-occurrence stamps that
the observed drivers (``run_observed``) carry next to the sim state, the
way the telemetry ring (:mod:`.telemetry`) rides it.

- :class:`ProvenanceSpec`: a host-side JSON-able spec naming the
  workload (and Kafka's witness node).
- The per-workload records, int32 tensors on the sim's device:

  * broadcast (:class:`BroadcastProv`): per (node, value) the
    **arrival** round (-1 unseen, 0 injected at the origin, t + 1 first
    present after round t) and the **parent** node that delivered it (-1
    at an origin), written where the round's ``new`` bits land, the
    parent the first delivering direction of the gather round
    (:func:`.kernels.prov_attribute`);
  * counter (:class:`CounterProv`): per node, the round its acked deltas
    first drained into the KV, the KV value they landed in, and the round
    every cache had caught up to that value;
  * Kafka (:class:`KafkaProv`): per (key, slot), the allocation round and
    origin node (from the same ``_alloc`` evaluation the round performs)
    and the slot's first presence at the witness node.

  Every write is first-incarnation (:func:`stamp`: only cells still
  below 0 are written), so an amnesia wipe never erases a stamp and a
  parent's first arrival always precedes the rounds it delivered in.

- The records are checked against the fault model itself on the host
  (:func:`..harness.checkers.check_provenance`): the loss and liveness
  coins are stateless ``(t, src, dst)`` hashes with numpy twins.

:func:`arrays_of` / :func:`from_arrays` carry a record across as numpy
arrays (the state counterpart of carrying weights across): between the
JAX package and the port, and into the checkers.

On a mesh (:class:`..parallel.mesh.Mesh`) the broadcast and counter
records are split by node, each rank holding its rows, and Kafka's is
whole on every rank (:func:`broadcast_specs`, :func:`counter_specs`,
:func:`kafka_specs`); the recorders add no all-gather to a round.

Env knob: ``GG_PROVENANCE`` (0 / 1, default off, parsed loudly).  Not
ported yet, and raising: the program audit's contracts (ROADMAP.md Queue
A item 14).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .engine import _env_int, host_unpack_bits, resolve_device

WORKLOADS = ("broadcast", "counter", "kafka")


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md Queue A item {item})")


@dataclass(frozen=True)
class ProvenanceSpec:
    """Host-side provenance spec, JSON-able (:meth:`to_meta`):
    ``witness`` is Kafka's first-presence observer node (node 0, the
    telemetry ``present_bits`` witness, by default)."""

    workload: str
    witness: int = 0

    def __post_init__(self) -> None:
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"unknown provenance workload {self.workload!r}; one "
                f"of {list(WORKLOADS)}")
        if self.witness < 0:
            raise ValueError("witness must be a node id >= 0")

    def to_meta(self) -> dict:
        return {"workload": self.workload, "witness": self.witness}

    @staticmethod
    def from_meta(meta: dict) -> "ProvenanceSpec":
        return ProvenanceSpec(workload=str(meta["workload"]),
                              witness=int(meta.get("witness", 0)))


class BroadcastProv(NamedTuple):
    """(N, V) int32 stamps."""

    arrival: torch.Tensor   # -1 unseen / 0 origin / t+1 first present
    parent: torch.Tensor    # -1 origin / node id that delivered


class CounterProv(NamedTuple):
    """(N,) int32 stamps."""

    flush_round: torch.Tensor    # -1 / t+1 first full pending drain
    flush_kv: torch.Tensor       # -1 / the KV value the flush landed in
    visible_round: torch.Tensor  # -1 / t+1 every cache >= flush_kv


class KafkaProv(NamedTuple):
    """(K, C) int32 stamps."""

    alloc_round: torch.Tensor    # -1 / t+1 the slot was allocated
    origin: torch.Tensor         # -1 / node id of the sender
    first_present: torch.Tensor  # -1 / t+1 first present at witness


def init_broadcast(n_nodes: int, n_values: int,
                   inject: np.ndarray | None = None,
                   device: str | torch.device | None = None
                   ) -> BroadcastProv:
    """A fresh broadcast record on ``device`` (CUDA unless given);
    ``inject`` ((N, W) uint32, the round-0 injection bitset) stamps the
    origin cells arrival 0, parent -1."""
    dev = resolve_device(device)
    arrival = np.full((n_nodes, n_values), -1, np.int32)
    if inject is not None:
        arrival[host_unpack_bits(inject, n_values)] = 0
    return BroadcastProv(
        arrival=torch.from_numpy(arrival).to(dev),
        parent=torch.full((n_nodes, n_values), -1, dtype=torch.int32,
                          device=dev))


def init_counter(n_nodes: int,
                 device: str | torch.device | None = None) -> CounterProv:
    dev = resolve_device(device)
    return CounterProv(*(torch.full((n_nodes,), -1, dtype=torch.int32,
                                    device=dev) for _ in range(3)))


def init_kafka(n_keys: int, capacity: int,
               device: str | torch.device | None = None) -> KafkaProv:
    dev = resolve_device(device)
    return KafkaProv(*(torch.full((n_keys, capacity), -1, dtype=torch.int32,
                                  device=dev) for _ in range(3)))


def broadcast_specs(axes="nodes") -> BroadcastProv:
    """The reference's shard specs of the record, one per leaf: the (N,
    V) stamps cut along the node axis with the gather state (``(axes,
    None)``), so a rank holds its rows."""
    return BroadcastProv((axes, None), (axes, None))


def counter_specs(axes="nodes") -> CounterProv:
    """The (N,) stamps cut along the node axis (``(axes,)``)."""
    return CounterProv((axes,), (axes,), (axes,))


def kafka_specs() -> KafkaProv:
    """The (K, C) stamps whole on every rank (``(None, None)``): the
    ranks' disjoint partials are summed into identical copies."""
    return KafkaProv((None, None), (None, None), (None, None))


def stamp(cur: torch.Tensor, mask: torch.Tensor, val) -> torch.Tensor:
    """Masked first-occurrence write: ``val`` where ``mask`` and ``cur``
    is still unstamped (< 0), ``cur`` elsewhere."""
    return torch.where(mask & (cur < 0),
                       torch.as_tensor(val, dtype=cur.dtype,
                                       device=cur.device), cur)


def critical_depth(stamps: torch.Tensor) -> torch.Tensor:
    """() int32: the last round a first-occurrence stamp landed
    (``max(stamps) - 1``, the t+1 convention), -1 when nothing past the
    origin was ever stamped."""
    return (stamps.max().to(torch.int32) - 1).clamp(min=-1)


# -- env knob -------------------------------------------------------------


def enabled(default: bool = False) -> bool:
    """The ``GG_PROVENANCE`` switch (default off); any value other than 0
    or 1 raises naming the variable."""
    raw = os.environ.get("GG_PROVENANCE")
    if raw is None:
        return default
    v = _env_int("GG_PROVENANCE", raw)
    if v not in (0, 1):
        raise ValueError(
            f"GG_PROVENANCE={v} must be 0 or 1 (provenance off/on)")
    return bool(v)


def default_spec(workload: str) -> ProvenanceSpec:
    return ProvenanceSpec(workload=workload)


def prov_key(prov, prov_spec, workload: str):
    """Validate a driver's ``(prov, prov_spec)`` pair (both or neither;
    the spec names this workload); returns the spec."""
    if (prov is None) != (prov_spec is None):
        raise ValueError(
            "pass prov and prov_spec together (build the record with "
            "the sim's provenance_state(spec, ...))")
    if prov_spec is not None and prov_spec.workload != workload:
        raise ValueError(
            f"run_observed provenance needs ProvenanceSpec(workload="
            f"{workload!r}), got {prov_spec.to_meta()}")
    return prov_spec


# -- host-side readout ----------------------------------------------------


_CLASSES = {"broadcast": BroadcastProv, "counter": CounterProv,
            "kafka": KafkaProv}


def arrays_of(prov) -> dict:
    """{field: numpy int32 array}, always a copy of the device record."""
    return {name: np.array(arr.cpu().numpy(), np.int32)
            for name, arr in zip(type(prov)._fields, prov)}


def from_arrays(workload: str, arrays: dict,
                device: str | torch.device | None = None):
    """The record of ``workload`` from its numpy (or JSON list) arrays,
    on ``device`` (CUDA unless given)."""
    cls = _CLASSES[workload]
    dev = resolve_device(device)
    return cls(*(torch.from_numpy(np.array(arrays[f], np.int32)).to(dev)
                 for f in cls._fields))


def depth_of(workload: str, arrays: dict) -> int:
    """Host twin of :func:`critical_depth` over a record's arrays, from
    the workload's dissemination field (broadcast ``arrival``, counter
    ``visible_round``, Kafka ``first_present``)."""
    field = {"broadcast": "arrival", "counter": "visible_round",
             "kafka": "first_present"}[workload]
    a = np.asarray(arrays[field], np.int64)
    m = int(a.max()) if a.size else -1
    return max(m - 1, -1)


def audit_contracts():
    """The provenance-on drivers' program contracts: ROADMAP.md Queue A
    item 14."""
    raise _unported("provenance.audit_contracts", 14)
