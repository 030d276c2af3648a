"""Flight-recorder telemetry on PyTorch: the port of
gossip_glomers_tpu/tpu_sim/telemetry.py — a per-round metrics ring that
the traffic drivers carry next to the sim state.

- :class:`TelemetrySpec`: a host-side JSON-able spec naming the
  workload, the ring capacity in rounds and the recorded series (a
  subset of the workload's canonical series; unselected columns record 0
  and their values are never computed).
- :class:`TelemetryState`: an ``(R, n_series)`` ring of int64 values
  holding the reference's uint32 entries (masked to 32 bits) on the
  device, and a host-int count of the rounds written; round ``t``'s row
  goes at ``t % R``.  Recording reads the round's states and never feeds
  back into them.
- Series conventions: ``live_nodes`` and the ``*_bits`` / ``*_total``
  gauges are instantaneous; ``msgs``, ``arrived``, ``issued``,
  ``completed``, ``deferred``, ``alloc_total`` and ``kv_total`` are
  running totals, so one row cross-checks the final ledgers
  (:func:`..harness.checkers.check_telemetry`).

On a mesh the ring is whole and equal on every rank
(:func:`state_specs`).  A round's row is built from the ranks' partials
(popcounts, pending sums, tracker counts: the columns the sim marks
``partial``) through one packed ``reduce_sum`` (:func:`record`), the
other columns being whole already (the ledger, the KV value, the
tracker's global counters); :func:`live_count` hashes the global id
range on every rank, with no collective.  No all-gather.

Env knobs, parsed loudly: ``GG_TELEMETRY`` (0 / 1) and
``GG_TELEMETRY_SERIES`` (a comma-separated subset).  The program audit's
contracts (:func:`audit_contracts`) are ROADMAP.md Queue A item 14.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from . import faults
from .engine import _env_int, resolve_device
from .faults import MASK32

# canonical per-workload series, in ring-column order (the reference's)
SIM_SERIES = {
    "broadcast": ("live_nodes", "frontier_bits", "new_bits",
                  "known_bits", "msgs"),
    "counter": ("live_nodes", "pending_total", "flush_attempts",
                "flush_acks", "cas_conflicts", "kv_total", "msgs"),
    "kafka": ("live_nodes", "alloc_total", "present_bits",
              "present_bits_full", "msgs"),
}
# canonical series that a default spec does NOT record: Kafka's
# full-cluster presence popcount re-reads the whole (N, K, Wc) bitset
OPT_IN_SERIES = {
    "kafka": ("present_bits_full",),
}
# appended when the spec records an open-loop traffic run
TRAFFIC_SERIES = ("arrived", "issued", "completed", "deferred")


def series_names(workload: str, traffic: bool = False) -> tuple:
    """The canonical ring-column names for one workload (+ the tracker
    columns when the run is open-loop)."""
    try:
        base = SIM_SERIES[workload]
    except KeyError:
        raise ValueError(
            f"unknown telemetry workload {workload!r}; one of "
            f"{sorted(SIM_SERIES)}") from None
    return base + (TRAFFIC_SERIES if traffic else ())


@dataclass(frozen=True)
class TelemetrySpec:
    """Host-side telemetry spec (the reference's): ``rounds`` the ring
    capacity R (a longer run keeps the last R rounds), ``series`` the
    recorded subset of :func:`series_names` (empty: every canonical
    series but the opt-in ones), ``traffic`` an open-loop run (appends
    the tracker columns)."""

    workload: str
    rounds: int
    traffic: bool = False
    series: tuple = field(default_factory=tuple)

    def __post_init__(self) -> None:
        known = series_names(self.workload, self.traffic)
        if self.rounds < 1:
            raise ValueError("telemetry ring needs rounds >= 1")
        opt_in = OPT_IN_SERIES.get(self.workload, ())
        sel = tuple(self.series) or tuple(s for s in known
                                          if s not in opt_in)
        bad = [s for s in sel if s not in known]
        if bad:
            raise ValueError(
                f"unknown telemetry series {bad} for workload "
                f"{self.workload!r} (traffic={self.traffic}); known: "
                f"{list(known)}")
        # canonical order, duplicates dropped
        object.__setattr__(
            self, "series", tuple(s for s in known if s in sel))

    @property
    def names(self) -> tuple:
        """Every ring-column name (the ring keeps the full canonical
        width whatever the subset)."""
        return series_names(self.workload, self.traffic)

    @property
    def width(self) -> int:
        return len(self.names)

    @property
    def static_mask(self) -> tuple:
        """Per-column bools: False columns record 0 and are not
        computed."""
        return tuple(n in self.series for n in self.names)

    def to_meta(self) -> dict:
        return {"workload": self.workload, "rounds": self.rounds,
                "traffic": self.traffic, "series": list(self.series)}

    @staticmethod
    def from_meta(meta: dict) -> "TelemetrySpec":
        return TelemetrySpec(
            workload=str(meta["workload"]), rounds=int(meta["rounds"]),
            traffic=bool(meta.get("traffic", False)),
            series=tuple(meta.get("series", ())))


class TelemetryState(NamedTuple):
    """The ring the traffic drivers carry."""

    ring: torch.Tensor   # (R, width) int64 holding uint32 values
    wrote: int           # rounds recorded (wrote > R: the ring wrapped)

    def clone(self) -> "TelemetryState":
        return TelemetryState(self.ring.clone(), self.wrote)


def state_specs() -> TelemetryState:
    """The reference's shard specs of the ring: whole on every rank
    (``(None, None)``; the round count ``()``)."""
    return TelemetryState((None, None), ())


def init_state(spec: TelemetrySpec,
               device: str | torch.device | None = None) -> TelemetryState:
    """An empty ring on ``device`` (CUDA unless given)."""
    return TelemetryState(
        ring=torch.zeros((spec.rounds, spec.width), dtype=torch.int64,
                         device=resolve_device(device)), wrote=0)


def record(tel: TelemetryState, t: int, vals, mask, partial=None,
           reduce_sum=None) -> TelemetryState:
    """Write round ``t``'s row at ``t % R``, in place: ``vals`` in the
    spec's canonical column order (tensors or ints; None where ``mask``,
    the spec's :attr:`TelemetrySpec.static_mask`, is False).  On a mesh,
    ``partial`` (a bool a column) marks the values that are a rank's
    partials: the kept ones are summed over the ranks in one packed
    ``reduce_sum``."""
    ring = tel.ring
    if reduce_sum is not None and partial is not None:
        cols = [i for i, (keep, part) in enumerate(zip(mask, partial))
                if keep and part]
        if cols:
            g = reduce_sum(torch.stack([
                torch.as_tensor(vals[i], device=ring.device).to(
                    torch.int64).reshape(()) for i in cols]))
            vals = list(vals)
            for j, i in enumerate(cols):
                vals[i] = g[j]

    def cell(v, keep: bool) -> torch.Tensor:
        if keep and isinstance(v, torch.Tensor):
            return v.to(torch.int64).reshape(())
        # a host int is filled on the device, never copied there
        return torch.full((), int(v) if keep else 0, dtype=torch.int64,
                          device=ring.device)

    ring[t % ring.shape[0]] = torch.stack(
        [cell(v, keep) for v, keep in zip(vals, mask)]) & MASK32
    return TelemetryState(ring, tel.wrote + 1)


def live_count(plan, t: int, n_nodes: int):
    """Nodes up at round ``t``: the constant N without a plan, else a ()
    int64 tensor."""
    if plan is None:
        return n_nodes
    ids = torch.arange(n_nodes, device=plan.down.device)
    return faults.node_up(plan, t, ids).sum(dtype=torch.int64)


# -- ring-derived signature components ---------------------------------
#
# They read the ring and assume it covers the whole run (rounds >= the
# rounds driven), so row t is round t.


def _prev(vals: torch.Tensor) -> torch.Tensor:
    return torch.cat([vals[:1], vals[:-1]])


def _valid_rows(r: int, wrote: int, device) -> tuple:
    t = torch.arange(r, dtype=torch.int32, device=device)
    return t, (t >= 1) & (t < min(int(wrote), r))


def ring_stall_round(ring: torch.Tensor, wrote: int, col: int,
                     conv_round: int) -> int:
    """The first recorded round ``t >= 1`` whose ``col`` running total
    did not move while the run was unconverged (``conv_round < 0`` or
    ``t < conv_round``); -1 when the column climbs every such round."""
    r = ring.shape[0]
    vals = ring[:, col]
    t, valid = _valid_rows(r, wrote, ring.device)
    unconv = (t < conv_round) if conv_round >= 0 else torch.ones_like(valid)
    stalled = valid & unconv & (vals == _prev(vals))
    first = int(torch.where(stalled, t, r).min())
    return -1 if first >= r else first


def ring_progress_depth(ring: torch.Tensor, wrote: int, col: int) -> int:
    """The last recorded round ``t >= 1`` whose ``col`` value changed
    from the row before; -1 when the column is flat after round 0."""
    vals = ring[:, col]
    t, valid = _valid_rows(ring.shape[0], wrote, ring.device)
    changed = valid & (vals != _prev(vals))
    return int(torch.where(changed, t, -1).max())


def log2_bucket(x: int, n_buckets: int = 14) -> int:
    """Coarse log2 bucket: -1 for a negative sentinel, else the count of
    powers of two <= x (0 -> 0, 1 -> 1, 2..3 -> 2, ...), capped at
    ``n_buckets``."""
    x = int(x)
    if x < 0:
        return -1
    return sum(1 for k in range(n_buckets) if x >= 1 << k)


def signature_columns(spec: TelemetrySpec) -> tuple[int, int]:
    """(msgs_col, progress_col): the ring columns the signature reads;
    both must be recorded."""
    progress = {"broadcast": "known_bits", "counter": "kv_total",
                "kafka": "present_bits"}[spec.workload]
    missing = [s for s in ("msgs", progress) if s not in spec.series]
    if missing:
        raise ValueError(
            f"behavioral signatures need telemetry series {missing} "
            f"recorded for workload {spec.workload!r}; got "
            f"series={list(spec.series)}")
    return spec.names.index("msgs"), spec.names.index(progress)


# -- env knobs -----------------------------------------------------------


def enabled(default: bool = False) -> bool:
    """The ``GG_TELEMETRY`` master switch (default off); any value other
    than 0 or 1 raises naming the variable."""
    raw = os.environ.get("GG_TELEMETRY")
    if raw is None:
        return default
    v = _env_int("GG_TELEMETRY", raw)
    if v not in (0, 1):
        raise ValueError(
            f"GG_TELEMETRY={v} must be 0 or 1 (telemetry off/on)")
    return bool(v)


def env_series(workload: str, traffic: bool = False) -> tuple | None:
    """The ``GG_TELEMETRY_SERIES`` subset (None: record all); an unknown
    name raises naming the variable."""
    raw = os.environ.get("GG_TELEMETRY_SERIES")
    if raw is None:
        return None
    names = tuple(s.strip() for s in raw.split(",") if s.strip())
    known = series_names(workload, traffic)
    bad = [s for s in names if s not in known]
    if bad:
        raise ValueError(
            f"GG_TELEMETRY_SERIES names unknown series {bad} for "
            f"workload {workload!r} (traffic={traffic}); known: "
            f"{list(known)}")
    if not names:
        raise ValueError(
            "GG_TELEMETRY_SERIES is set but selects no series; unset "
            "it to record everything")
    return names


def default_spec(workload: str, rounds: int,
                 traffic: bool = False) -> TelemetrySpec:
    """The spec a runner builds when telemetry is on without one: the
    canonical series, filtered by ``GG_TELEMETRY_SERIES``."""
    sel = env_series(workload, traffic)
    return TelemetrySpec(workload=workload, rounds=max(1, rounds),
                         traffic=traffic, series=sel or ())


def tel_key(tel, tel_spec, workload: str):
    """Validate a traffic driver's ``(tel, tel_spec)`` pair (both or
    neither; the spec names this workload with ``traffic=True``); returns
    the spec."""
    if (tel is None) != (tel_spec is None):
        raise ValueError(
            "pass tel and tel_spec together (build the ring with "
            "telemetry.init_state(spec))")
    if tel_spec is not None and (tel_spec.workload != workload
                                 or not tel_spec.traffic):
        raise ValueError(
            f"run_traffic telemetry needs TelemetrySpec(workload="
            f"{workload!r}, traffic=True), got {tel_spec.to_meta()}")
    return tel_spec


# -- host-side readout ---------------------------------------------------


def ring_rows(tel: TelemetryState,
              spec: TelemetrySpec) -> tuple[np.ndarray, int, bool]:
    """(rows, first_round, wrapped): the recorded rows in round order;
    ``rows[i]`` is round ``first_round + i``."""
    ring = tel.ring.cpu().numpy()
    wrote = int(tel.wrote)
    r = ring.shape[0]
    if wrote <= r:
        return ring[:wrote], 0, False
    head = wrote % r
    return np.concatenate([ring[head:], ring[:head]]), wrote - r, True


def series_arrays(tel: TelemetryState, spec: TelemetrySpec) -> dict:
    """{name: list[int]} for the recorded series, plus ``_round`` (each
    row's round) and ``_wrapped``."""
    rows, first, wrapped = ring_rows(tel, spec)
    out: dict = {
        "_round": list(range(first, first + rows.shape[0])),
        "_wrapped": wrapped,
    }
    for i, name in enumerate(spec.names):
        if name in spec.series:
            out[name] = [int(v) for v in rows[:, i]]
    return out


def audit_contracts():
    """The telemetry-on drivers' program contracts: ROADMAP.md Queue A
    item 14."""
    raise NotImplementedError("telemetry.audit_contracts is not ported to "
                              "PyTorch yet (ROADMAP.md Queue A item 14)")
