"""Checkpoint / resume for the port's sim states: the port of
gossip_glomers_tpu/tpu_sim/checkpoint.py.

A checkpoint is one compressed ``.npz``: an array a field and a
``__meta__`` JSON of ``fields`` (the present ones, in the reference's
order), ``none_fields``, ``class`` and the caller's meta, with the fault
spec of a faulted run under ``fault_spec`` (``NemesisSpec.to_meta()``).
Both packages read and write the same file: the port writes every field
as the reference's state holds it, so a file either one writes restores
in the other.

The port's states differ in form from the reference's: ``t`` is a host
int, the uint32 ledgers are int64 tensors, the uint32 bitsets are int32
views, and ``BroadcastState`` is a dataclass whose ``srv_msgs`` comes
before ``history``.  :data:`FIELDS` is therefore a table, per state
class, of the reference's field order and each field's form: bitsets
are written as their uint32 view, ledgers as uint32, ``t`` as a 0-d
int32.  :func:`restore` maps each array back to the port's dtype and
puts it on :func:`.engine.resolve_device` ``(device)`` (or hands it to
``device_put(name, array)``).  Layouts need no map: words-major states
are ``(W, N)`` and node-major ``(N, W)`` in both packages.

A device-KV state's ``rows`` (a :class:`.kvstore.KVRows` pair) is written
as the reference writes it, one stacked ``(2, N, cap)`` int32 array, so
the two files stay equal; :func:`restore` refuses such a file, naming
the reason (the reference hands the stacked array back in place of the
pair, and the restored state fails on its first step).
"""

from __future__ import annotations

import json
from typing import Any, Callable

import numpy as np
import torch

from .engine import resolve_device

# field forms: "bits" uint32 in the file, an int32 view in the port;
# "ledger" uint32 in the file, int64 in the port; "i32" int32 in both;
# "t" a 0-d int32 in the file, a host int in the port; "rows" the
# stacked (2, N, cap) KVRows pair
FIELDS: dict[str, tuple[tuple[str, str], ...]] = {
    "BroadcastState": (("received", "bits"), ("frontier", "bits"),
                       ("t", "t"), ("msgs", "ledger"),
                       ("history", "bits"), ("srv_msgs", "ledger")),
    "CounterState": (("pending", "i32"), ("cached", "i32"), ("kv", "i32"),
                     ("t", "t"), ("msgs", "ledger"), ("rows", "rows")),
    "KafkaState": (("log_vals", "i32"), ("present", "bits"),
                   ("kv_val", "i32"), ("local_committed", "i32"),
                   ("origin_bits", "bits"), ("t", "t"), ("msgs", "ledger"),
                   ("rows", "rows")),
    "UniqueIdsState": (("t", "t"), ("minted", "i32")),
    "EchoState": (("t", "t"), ("msgs", "ledger")),
    "TxnState": (("rows", "rows"), ("arrived", "i32"), ("cur", "i32"),
                 ("issue", "i32"), ("issue_round", "i32"),
                 ("commit_round", "i32"), ("op_ver", "i32"),
                 ("op_val", "i32"), ("t", "t"), ("msgs", "ledger")),
}


def _forms(cls: type) -> tuple[tuple[str, str], ...]:
    """The (field, form) pairs of ``cls`` in the reference's order."""
    table = FIELDS.get(cls.__name__)
    if table is None:
        raise TypeError(f"no checkpoint form for {cls.__name__}: the "
                        f"sim states are {sorted(FIELDS)}")
    return table


def _to_file(v, form: str) -> np.ndarray:
    if form == "t":
        return np.asarray(int(v), np.int32)
    if form == "rows":
        return np.stack([v.vals.cpu().numpy(), v.vers.cpu().numpy()])
    a = v.detach().cpu().numpy()
    if form == "bits":
        return a.view(np.uint32)
    if form == "ledger":
        return a.astype(np.uint32)
    return a.astype(np.int32, copy=False)


def _to_port(a: np.ndarray, form: str) -> np.ndarray:
    if form == "bits":
        return np.ascontiguousarray(a).view(np.int32)
    if form == "ledger":
        return a.astype(np.int64)
    return a.astype(np.int32, copy=False)


def save(path: str, state: Any, meta: dict | None = None, *,
         fault_spec=None) -> None:
    """Write a sim state as one compressed npz, the reference's format
    (module docstring).  ``fault_spec``: the active nemesis spec of a
    faulted run (a ``faults.NemesisSpec`` or its ``to_meta()`` dict),
    stored under ``"fault_spec"`` so that a resume rebuilds the same
    seeded plan (its windows and coins are pure functions of the spec and
    the round, so a run checkpointed mid fault window and resumed equals
    the uninterrupted run).  Each field is copied to the host once."""
    meta = dict(meta or {})
    if fault_spec is not None:
        meta["fault_spec"] = (fault_spec if isinstance(fault_spec, dict)
                              else fault_spec.to_meta())
    forms = _forms(type(state))
    present = [f for f, _ in forms if getattr(state, f) is not None]
    payload = {f: _to_file(getattr(state, f), form) for f, form in forms
               if f in present}
    payload["__meta__"] = np.frombuffer(
        json.dumps({"fields": present,
                    "none_fields": [f for f, _ in forms
                                    if f not in present],
                    "class": type(state).__name__,
                    **meta}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def fault_spec_from_meta(meta: dict):
    """Rebuild the checkpointed ``NemesisSpec`` from :func:`restore`'s
    meta dict, or None when the run was fault-free."""
    raw = meta.get("fault_spec")
    if raw is None:
        return None
    from .faults import NemesisSpec
    return NemesisSpec.from_meta(raw)


def restore(path: str, state_cls: type, *,
            device: str | torch.device | None = None,
            device_put: Callable[[str, np.ndarray], Any] | None = None,
            ) -> tuple[Any, dict]:
    """Load a state that :func:`save` (of either package) wrote.  Returns
    ``(state, meta)``.  Each array becomes the port's dtype on ``device``
    (CUDA unless given), once; ``device_put(field_name, array)`` may
    place it instead (``t`` stays a host int).  A wrong class, and a
    device-KV state's stacked ``rows``, are refused."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["class"] != state_cls.__name__:
            raise ValueError(
                f"checkpoint holds {meta['class']}, not "
                f"{state_cls.__name__}")
        forms = dict(_forms(state_cls))
        if "rows" in meta["fields"]:
            raise ValueError(
                f"checkpoint holds a device-KV {state_cls.__name__}: its "
                "rows are one stacked (2, N, cap) array, which the "
                "reference restores in place of a KVRows pair and whose "
                "state then fails on its first step; the port refuses "
                "it rather than return such a state (ROADMAP.md Queue C)")
        dev = None if device_put is not None else resolve_device(device)
        vals = {}
        for f in meta["fields"]:
            form = forms[f]
            arr = z[f]
            if form == "t":
                vals[f] = int(arr)
                continue
            arr = _to_port(arr, form)
            vals[f] = (device_put(f, arr) if device_put is not None
                       else torch.from_numpy(np.array(arr)).to(dev))
        for f in meta.get("none_fields", []):
            vals[f] = None
    extra = {k: v for k, v in meta.items()
             if k not in ("fields", "none_fields", "class")}
    return state_cls(**vals), extra
