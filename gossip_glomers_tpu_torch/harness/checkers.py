"""The runners' checkers: a partial copy of
gossip_glomers_tpu/harness/checkers.py, kept as the reference has them —
``check_recovery``, ``check_op_latency``, ``check_telemetry`` and the
helper ``series_divergence_round`` (tests/test_torch_serving.py holds
each equal to the original on seeded inputs), the scenario batches'
``check_recovery_batch`` and the serving cells' ``check_slo``
(tests/test_torch_scenario.py), and the causal provenance
certifier ``check_provenance`` with ``provenance_divergence_round``
(tests/test_torch_nemesis_runner.py and test_torch_provenance.py), and
the txn-rw-register history's ``check_txn_serializable``
(tests/test_torch_txn.py), and the bounded-staleness certificate
``check_staleness_bound`` (tests/test_torch_dcn_mode.py).  It reads the fault model through the port's
:mod:`..tpu_sim.faults` host twins (``host_node_up``,
``host_edge_drop``, ``host_kv_ok``).  The other workload checkers
(``check_kafka`` and the rest) wait for the port's runners that need
them.

Each checker returns ``(ok, details)``.
"""

from __future__ import annotations

import bisect


def check_recovery(*, clear_round: int, converged_round: int | None,
                   max_recovery_rounds: int, lost_writes: list,
                   msgs_at_clear: int | None = None,
                   msgs_at_converged: int | None = None,
                   latency: dict | None = None,
                   divergence: int | None = None,
                   ) -> tuple[bool, dict]:
    """Recovery certification under a nemesis plan (the tpu_sim
    counterpart of Maelstrom's post-heal availability/validity checks):
    after the last fault window clears at ``clear_round``, the run must

    - converge within ``max_recovery_rounds`` rounds
      (``converged_round`` is the absolute round convergence was first
      observed; None = never), and
    - lose NO acknowledged writes (``lost_writes``: the workload's
      evidence list — broadcast values absent from every node, counter
      delta shortfall, kafka allocated slots missing everywhere, an
      open-loop serving run's forever-in-flight acked ops).

    Reports ``recovery_rounds`` (rounds from clear to convergence) and
    the ``degraded_throughput`` summary.  **Units**: both phases are
    measured in *messages per round* — ``msgs_per_round_faulted`` is
    ``msgs_at_clear / clear_round`` (total messages sent while faults
    were active, averaged over the faulted rounds) and
    ``msgs_per_round_recovery`` is the recovery phase's increment
    averaged over its rounds; ``degraded_throughput`` is their
    DIMENSIONLESS ratio (faulted-phase msgs/round over recovery-phase
    msgs/round — >= 1 means the fault phase burned more traffic per
    round than the repair phase: retries, re-floods and duplicates at
    work).

    ``latency``: an open-loop run's tracker summary
    (tpu_sim/traffic.py ``latency_summary``) — its ``lat_p50`` /
    ``lat_p99`` / ``lat_max`` per-op latency keys (rounds) surface
    through this details dict, next to the recovery keys.

    ``divergence``: a first-divergence round computed against
    a reference record (a flight bundle's telemetry series or
    provenance stamps — harness/observe.py ``replay_bundle``), the
    fuzzer's shrinker hook: it surfaces as
    ``details['first_divergence_round']`` so an auto-shrinker can
    bisect the fault spec toward the earliest diverging round.
    """
    recovery = (None if converged_round is None
                else converged_round - clear_round)
    ok = (converged_round is not None
          and recovery <= max_recovery_rounds
          and not lost_writes)
    details: dict = {
        "clear_round": clear_round,
        "converged_round": converged_round,
        "recovery_rounds": recovery,
        "max_recovery_rounds": max_recovery_rounds,
        "n_lost_writes": len(lost_writes),
        "lost_writes": list(lost_writes)[:10],
    }
    if msgs_at_clear is not None and clear_round > 0:
        faulted = msgs_at_clear / clear_round
        details["msgs_per_round_faulted"] = faulted
        if (msgs_at_converged is not None and recovery
                and recovery > 0):
            rec_rate = (msgs_at_converged - msgs_at_clear) / recovery
            details["msgs_per_round_recovery"] = rec_rate
            if rec_rate > 0:
                details["degraded_throughput"] = faulted / rec_rate
    if latency is not None:
        for key in ("lat_p50", "lat_p99", "lat_max"):
            if key in latency:
                details[key] = latency[key]
    if divergence is not None:
        details["first_divergence_round"] = divergence
    return ok, details


def check_staleness_bound(*, stale_k: int,
                          sync_converged_round: int | None,
                          stale_converged_round: int | None,
                          lost_writes: list,
                          recovery: tuple | None = None,
                          ) -> tuple[bool, dict]:
    """Bounded-staleness certification: a ``stale:k`` run's
    cross-host partials may lag at most ``k`` rounds behind the
    synchronous twin, so the whole run must

    - converge no more than ``k`` rounds after the k=0 (sync) twin
      did (``sync_converged_round`` / ``stale_converged_round`` are
      the absolute rounds convergence was first observed; None =
      never — a stale run that never converges while the sync twin
      did is an unbounded-staleness violation, not a tie), and
    - lose NO acknowledged writes (``lost_writes``: the workload's
      evidence list, same shape :func:`check_recovery` takes — a
      flushed delta riding the staleness carry is still durable, so
      ANY shortfall falsifies the deferred-delivery model).

    The check is falsifiable by construction: a run whose partials
    actually lag ``k + 1`` rounds converges past the bound, and the
    details name the violating round — ``bound_round`` is
    ``sync_converged_round + stale_k`` and ``violating_round`` is the
    stale run's converged round whenever it lands beyond the bound
    (or -1 for "never converged").

    ``recovery``: an optional composed :func:`check_recovery` verdict
    ``(ok, details)`` for the SAME stale run (crash+loss nemesis on
    top of staleness) — its failure fails this check too and its
    details nest under ``details['recovery']``.
    """
    if stale_k < 0:
        raise ValueError(f"stale_k must be >= 0, got {stale_k}")
    details: dict = {
        "stale_k": stale_k,
        "sync_converged_round": sync_converged_round,
        "stale_converged_round": stale_converged_round,
        "n_lost_writes": len(lost_writes),
        "lost_writes": list(lost_writes)[:10],
    }
    if sync_converged_round is None:
        # no sync baseline: nothing to bound against — only the
        # lost-writes half of the contract is decidable
        ok = not lost_writes
        details["bound_round"] = None
        details["delay_rounds"] = None
    else:
        bound = sync_converged_round + stale_k
        details["bound_round"] = bound
        if stale_converged_round is None:
            ok = False
            details["delay_rounds"] = None
            details["violating_round"] = -1
        else:
            delay = stale_converged_round - sync_converged_round
            details["delay_rounds"] = delay
            ok = delay <= stale_k and not lost_writes
            if stale_converged_round > bound:
                details["violating_round"] = stale_converged_round
    if recovery is not None:
        rec_ok, rec_details = recovery
        ok = ok and bool(rec_ok)
        details["recovery"] = rec_details
        details["recovery_ok"] = bool(rec_ok)
    return ok, details


def check_recovery_batch(*, clear_rounds, converged_rounds,
                         max_recovery_rounds: int, lost_writes,
                         msgs_at_clear=None, msgs_at_converged=None,
                         ) -> tuple[bool, dict]:
    """Batched :func:`check_recovery` over per-SCENARIO row arrays (the
    scenario batches' verdict layer): every input is an (S,) array —
    ``converged_rounds`` uses -1 for "never converged within bound"
    (the sentinel of tpu_sim/scenario.py ``certify_loop``) — except
    ``lost_writes``, a list of S per-scenario evidence lists.  The rows
    come off the batch's one transfer; each row's verdict is the scalar
    :func:`check_recovery` itself, so the batched and sequential
    certifiers cannot drift.  The details dict carries:

    - ``scenarios``: the :func:`check_recovery` verdict dict per
      scenario (the scalar checker itself runs per row, so the two
      can never drift) with ``ok`` folded in;
    - ``failing``: the indices of every failing scenario — a single
      planted bad scenario in a batch fails LOUDLY and is named by
      index (``problems`` strings; tests/test_torch_scenario_batch.py
      plants one).
    """
    import numpy as np

    clear = np.asarray(clear_rounds, np.int64)
    conv = np.asarray(converged_rounds, np.int64)
    s = clear.shape[0]
    if conv.shape[0] != s or len(lost_writes) != s:
        raise ValueError(
            f"batch shape mismatch: {s} clear rounds, "
            f"{conv.shape[0]} converged rounds, "
            f"{len(lost_writes)} lost-writes lists")
    mc = (None if msgs_at_clear is None
          else np.asarray(msgs_at_clear, np.int64))
    mv = (None if msgs_at_converged is None
          else np.asarray(msgs_at_converged, np.int64))
    rows: list[dict] = []
    problems: list[str] = []
    failing: list[int] = []
    for i in range(s):
        ok_i, det = check_recovery(
            clear_round=int(clear[i]),
            converged_round=(int(conv[i]) if conv[i] >= 0 else None),
            max_recovery_rounds=max_recovery_rounds,
            lost_writes=list(lost_writes[i]),
            msgs_at_clear=(None if mc is None else int(mc[i])),
            msgs_at_converged=(None if mv is None else int(mv[i])))
        rows.append({"ok": ok_i, **det})
        if not ok_i:
            failing.append(i)
            if len(problems) < 10:
                why = ("never converged" if conv[i] < 0
                       else f"lost {len(lost_writes[i])} acked writes"
                       if lost_writes[i] else
                       f"recovery took {int(conv[i] - clear[i])} "
                       f"rounds (> {max_recovery_rounds})")
                problems.append(f"scenario {i}: {why}")
    return not failing, {
        "n_scenarios": s,
        "n_ok": s - len(failing),
        "failing": failing,
        "problems": problems,
        "scenarios": rows,
    }


def check_op_latency(summary: dict, *, p99_max_rounds: float,
                     max_rounds: int | None = None,
                     min_completed: int = 1) -> tuple[bool, dict]:
    """Per-op latency bound over an open-loop tracker summary
    (tpu_sim/traffic.py ``latency_summary``): the run fails when its
    p99 op latency (rounds) exceeds ``p99_max_rounds``, when its max
    exceeds ``max_rounds`` (if given), when fewer than
    ``min_completed`` ops completed, or when the tracker's
    conservation invariant (arrived == issued + deferred) broke.  A
    deliberately-delayed op must fail the bound —
    the serving tests prove it (a checker that cannot fail is
    decoration)."""
    completed = summary.get("completed", 0)
    problems: list[str] = []
    if not summary.get("conserved", True):
        problems.append("conservation broke: arrived != issued + "
                        "deferred (a silently-dropped arrival)")
    if completed < min_completed:
        problems.append(
            f"only {completed} ops completed (< {min_completed})")
    elif completed > 0:        # min_completed=0: an empty run is
        if summary["lat_p99"] > p99_max_rounds:  # vacuously in bound
            problems.append(
                f"p99 latency {summary['lat_p99']} rounds > bound "
                f"{p99_max_rounds}")
        if max_rounds is not None and summary["lat_max"] > max_rounds:
            problems.append(
                f"max latency {summary['lat_max']} rounds > bound "
                f"{max_rounds}")
    return not problems, {
        "completed": completed,
        "lat_p50": summary.get("lat_p50"),
        "lat_p99": summary.get("lat_p99"),
        "lat_max": summary.get("lat_max"),
        "p99_max_rounds": p99_max_rounds,
        "max_rounds": max_rounds,
        "problems": problems}


def check_slo(row: dict, *, p99_max_rounds: float | None = None,
              max_rounds: int | None = None,
              min_completed: int = 1,
              min_sustained: float | None = None,
              max_recovery_rounds: int | None = None,
              require_converged: bool = True,
              coords=None) -> tuple[bool, dict]:
    """Falsifiable SLO verdict over ONE serving-frontier grid cell
    (tpu_sim/scenario.py ``collect_serving_batch`` row, or a
    sequential ``run_serving`` details dict — same keys, so the two
    certifiers cannot drift).  A cell fails when

    - its p99 / max per-op latency (rounds) exceeds the bound,
    - fewer than ``min_completed`` ops completed,
    - sustained throughput (``sustained_per_round``, completed ops
      per round over the whole horizon) falls below
      ``min_sustained``,
    - it never drained its in-flight ops (``require_converged``) or
      took more than ``max_recovery_rounds`` rounds past clear, or
    - the tracker's conservation invariant broke.

    Every problem string names the cell's grid coordinates
    (``coords`` argument, else the row's own ``coords`` key) so one
    bad cell in a 256-cell surface is identified without re-running
    anything."""
    at = coords if coords is not None else row.get("coords")
    where = f"cell{tuple(at)!r}" if at else f"cell {row.get('cell')}"
    completed = int(row.get("completed", 0))
    problems: list[str] = []
    if not row.get("conserved", True):
        problems.append(f"{where}: conservation broke (arrived != "
                        "issued + deferred)")
    if completed < min_completed:
        problems.append(f"{where}: only {completed} ops completed "
                        f"(< {min_completed})")
    elif completed > 0:
        if (p99_max_rounds is not None
                and row["lat_p99"] > p99_max_rounds):
            problems.append(
                f"{where}: p99 latency {row['lat_p99']} rounds > "
                f"SLO {p99_max_rounds}")
        if max_rounds is not None and row["lat_max"] > max_rounds:
            problems.append(
                f"{where}: max latency {row['lat_max']} rounds > "
                f"SLO {max_rounds}")
    if (min_sustained is not None
            and row.get("sustained_per_round", 0.0) < min_sustained):
        problems.append(
            f"{where}: sustained {row.get('sustained_per_round')} "
            f"ops/round < SLO {min_sustained}")
    if require_converged and row.get("converged_round") is None:
        problems.append(
            f"{where}: never drained ({row.get('in_flight', '?')} "
            "acked ops still in flight)")
    rec = row.get("recovery_rounds")
    if (max_recovery_rounds is not None and rec is not None
            and rec > max_recovery_rounds):
        problems.append(
            f"{where}: recovery took {rec} rounds "
            f"(> {max_recovery_rounds})")
    return not problems, {
        "coords": (list(at) if at is not None else None),
        "cell": row.get("cell"),
        "completed": completed,
        "lat_p50": row.get("lat_p50"),
        "lat_p99": row.get("lat_p99"),
        "lat_max": row.get("lat_max"),
        "sustained_per_round": row.get("sustained_per_round"),
        "recovery_rounds": rec,
        "problems": problems}


def check_frontier_batch(rows: list, slo: dict) -> tuple[bool, dict]:
    """Batched :func:`check_slo` over the per-cell rows of one serving
    frontier (``run_serving_batch``): the scalar checker runs per row,
    failing cells are named by index and grid coordinates, and the
    details carry every per-cell verdict for the frontier table."""
    verdicts: list[dict] = []
    failing: list[int] = []
    problems: list[str] = []
    for i, row in enumerate(rows):
        ok_i, det = check_slo(row, **slo)
        verdicts.append({"ok": ok_i, **det})
        if not ok_i:
            failing.append(i)
            if len(problems) < 16:
                problems.extend(det["problems"][:2])
    return not failing, {
        "n_cells": len(rows),
        "n_ok": len(rows) - len(failing),
        "failing": failing,
        "problems": problems,
        "slo": dict(slo),
        "cells": verdicts}


def series_divergence_round(expected: dict, got: dict) -> int | None:
    """First absolute round at which two recorded telemetry series
    dicts (tpu_sim/telemetry.py ``series_arrays``) disagree on any
    shared series, or None when every shared value matches — the
    per-round divergence signal a flight-bundle replay reports (the
    fuzzer's shrinker hook)."""
    er = expected.get("_round") or []
    gi = {r: i for i, r in enumerate(got.get("_round") or [])}
    keys = [k for k in expected
            if not k.startswith("_") and k in got]
    for i, r in enumerate(er):
        j = gi.get(r)
        if j is None:
            continue
        for k in keys:
            if expected[k][i] != got[k][j]:
                return int(r)
    return None


# every provenance field's ROUND companion: the field whose value at
# a differing cell IS the round the two records disagree about.
# Round-valued fields are their own companion; id/value-valued fields
# (broadcast `parent` = a node id, kafka `origin` = a node id,
# counter `flush_kv` = a KV value) borrow the cell's round stamp —
# without this, a divergence-only-in-parent would report the NODE ID
# as the "round".
_ROUND_COMPANION = {
    "arrival": "arrival", "parent": "arrival",
    "flush_round": "flush_round", "flush_kv": "flush_round",
    "visible_round": "visible_round",
    "alloc_round": "alloc_round", "origin": "alloc_round",
    "first_present": "first_present",
}


def provenance_divergence_round(expected: dict, got: dict
                                ) -> int | None:
    """First round two provenance stamp records (tpu_sim/provenance.py
    ``arrays_of``, possibly JSON round-tripped) disagree about, or
    None when identical.  The round of a differing cell is its
    ROUND-companion field's value (``_ROUND_COMPANION`` — node-id and
    KV-value fields borrow the cell's round stamp); the earliest
    non-negative one (either record's — whichever claims the earlier
    event first disagrees there) wins; a shape mismatch diverges at
    round 0."""
    import numpy as np

    first = None
    for key in expected:
        if key not in got:
            continue
        a = np.asarray(expected[key], np.int64)
        b = np.asarray(got[key], np.int64)
        if a.shape != b.shape:
            return 0
        diff = a != b
        if not diff.any():
            continue
        comp = _ROUND_COMPANION.get(key, key)
        ca = (np.asarray(expected[comp], np.int64)
              if comp in expected else a)
        cb = np.asarray(got[comp], np.int64) if comp in got else b
        if ca.shape != a.shape or cb.shape != b.shape:
            return 0
        stamps = np.concatenate([ca[diff], cb[diff]])
        stamps = stamps[stamps >= 0]
        cand = int(stamps.min()) if stamps.size else 0
        first = cand if first is None else min(first, cand)
    return first


def check_telemetry(series: dict, *, msgs_total: int | None = None,
                    traffic: dict | None = None,
                    expected: dict | None = None) -> tuple[bool, dict]:
    """Conservation cross-check of a recorded telemetry ring
    (tpu_sim/telemetry.py ``series_arrays``) against the run's final
    ledgers: the device-resident series must agree with the
    accounting the sims already keep, or the recorder itself is
    broken.

    - ``msgs_total``: the final ``state.msgs`` — the ring's ``msgs``
      running total must end exactly there (mod 2^32, the ledger's
      own wrap), and must be non-decreasing row to row.
    - ``traffic``: the tracker summary (``latency_summary``) — the
      loud-backpressure identity ``arrived == issued + deferred``
      must hold at EVERY recorded round, and the final row must match
      the tracker's totals.

    - ``expected``: a REFERENCE series dict (e.g. a flight
      bundle's recorded series) — any disagreement fails loudly and
      the first diverging round surfaces as
      ``details['first_divergence_round']`` (the shrinker hook; a
      deterministic replay must never diverge from its bundle).

    A check whose column was not recorded (a ``GG_TELEMETRY_SERIES``
    subset) cannot run; it is listed in ``details['skipped']`` so a
    vacuous pass is never silent.

    Falsifiable by construction (a mutated series must fail) —
    the serving tests prove it."""
    problems: list[str] = []
    skipped: list[str] = []
    divergence = None
    if expected is not None:
        divergence = series_divergence_round(expected, series)
        if divergence is not None:
            problems.append(
                f"recorded series diverge from the expected record "
                f"at round {divergence} (a deterministic replay must "
                "reproduce its bundle's series bit for bit)")
    msgs = series.get("msgs")
    if msgs_total is not None and not msgs:
        skipped.append("msgs-vs-ledger (series 'msgs' not recorded)")
    if msgs_total is not None and msgs:
        want = msgs_total & 0xFFFFFFFF
        if msgs[-1] != want:
            problems.append(
                f"telemetry msgs[-1]={msgs[-1]} != ledger total "
                f"{want}")
        for i in range(1, len(msgs)):
            # serial arithmetic: the ledger wraps @2^32, so a
            # decrease is legal exactly when the unsigned delta is a
            # small forward step past the wrap
            delta = (msgs[i] - msgs[i - 1]) & 0xFFFFFFFF
            if msgs[i] < msgs[i - 1] and delta >= 1 << 31:
                problems.append(
                    f"msgs running total decreased at recorded row "
                    f"{i}: {msgs[i - 1]} -> {msgs[i]}")
                break
    if traffic is not None:
        arr = series.get("arrived") or []
        iss = series.get("issued") or []
        dfr = series.get("deferred") or []
        if not (arr and iss and dfr):
            missing = [k for k, c in (("arrived", arr), ("issued", iss),
                                      ("deferred", dfr)) if not c]
            skipped.append(
                f"arrived == issued + deferred (series {missing} "
                "not recorded)")
        for i, (a, b, c) in enumerate(zip(arr, iss, dfr)):
            if a != b + c:
                problems.append(
                    f"arrived != issued + deferred at recorded row "
                    f"{i}: {a} != {b} + {c} (a silently-dropped "
                    "arrival)")
                break
        for key, col in (("arrived", arr), ("deferred", dfr),
                         ("completed", series.get("completed") or [])):
            want = traffic.get(key)
            if want is not None and not col:
                skipped.append(
                    f"{key}-vs-tracker (series {key!r} not recorded)")
            if want is not None and col and col[-1] != want:
                problems.append(
                    f"telemetry {key}[-1]={col[-1]} != tracker "
                    f"{want}")
    details = {
        "problems": problems,
        "skipped": skipped,
        "rounds_recorded": len(series.get("_round", ())),
        "wrapped": bool(series.get("_wrapped", False))}
    if expected is not None:
        details["first_divergence_round"] = divergence
    return not problems, details


def _parts_cut(parts_meta, t: int, a_ids, b_ids):
    """Host twin of the partition-window edge gate: True where the
    (a -> b) edge is CUT at round ``t`` by an active window of the
    JSON-able Partitions meta ({starts, ends, group})."""
    import numpy as np

    if parts_meta is None:
        return np.zeros(np.asarray(a_ids).shape, bool)
    cut = np.zeros(np.asarray(a_ids).shape, bool)
    group = np.asarray(parts_meta["group"])
    for w, (s, e) in enumerate(zip(parts_meta["starts"],
                                   parts_meta["ends"])):
        if s <= t < e:
            cut |= group[w][np.asarray(a_ids)] \
                != group[w][np.asarray(b_ids)]
    return cut


def check_provenance(workload: str, prov: dict, *, spec=None,
                     **ctx) -> tuple[bool, dict]:
    """Causal-provenance certification — the headline checker
    of the provenance record (tpu_sim/provenance.py), falsifiable
    *against the fault model itself*: the loss/liveness coins are
    stateless ``(t, src, dst)`` hashes with exact numpy twins
    (tpu_sim/faults.py ``host_node_up`` / ``host_edge_drop``), so the
    host re-evaluates whether each claimed causal edge was actually
    LIVE and UN-DROPPED at the claimed round.  ``prov`` is the
    workload's stamp arrays (``provenance.arrays_of``), ``spec`` the
    run's NemesisSpec (or None fault-free).

    Per workload (all verdicts ANDed):

    - **broadcast** (ctx: ``nbrs``, ``received`` (N, V) bool,
      ``msgs_total``, optional ``parts`` meta and per-edge ``delays``):
      *reachability* — every held (node, value) bit has a recorded
      arrival; *causality* — every non-origin arrival names a parent
      with ``arrival[parent] < arrival[child]``; *edge validity* —
      the parent is a topology in-neighbor and the edge was live
      (both endpoints up, no active partition window cutting it) and
      un-dropped by the loss coin at the SEND round (``arrival - 1``,
      or ``arrival - delay(edge)`` under per-edge delays, with the
      receiver also up at the delivery round); *ledger consistency* —
      the spanning trees' edge count cannot exceed the value-message
      ledger (every first delivery consumed at least one send).
    - **counter** (ctx: ``final_kv``): every flush stamp names a
      round at which the node could actually reach the KV
      (``host_kv_ok`` — up and the KV coin un-dropped), flushed into
      a value the monotone KV actually passed (``1 <= flush_kv <=
      final_kv``), and visibility never precedes the flush.
    - **kafka** (ctx: ``n_nodes``, ``resync_every``, ``resync_mode``,
      ``witness``): every allocated slot's origin was up WITH KV
      reach at the allocation round; first presence at the witness
      never precedes allocation; a same-round witness presence
      required a live, un-dropped (origin -> witness) replicate
      delivery; a LATER witness presence is only explainable by an
      anti-entropy resync round (witness live; push mode: origin
      live too).

    A forged parent on a dropped or dead edge, a causality-violating
    arrival, and a tree-inconsistent msgs ledger each fail loudly —
    tests/test_provenance.py proves all three."""
    import numpy as np

    plan = spec.compile(device="cpu") if spec is not None else None
    if workload == "broadcast":
        ok_fn = _check_broadcast_provenance
    elif workload == "counter":
        ok_fn = _check_counter_provenance
    elif workload == "kafka":
        ok_fn = _check_kafka_provenance
    else:
        raise ValueError(f"unknown provenance workload {workload!r}")
    prov = {k: np.asarray(v) for k, v in prov.items()}
    return ok_fn(prov, plan, **ctx)


def _host_up(plan, t: int):
    from ..tpu_sim import faults as F
    return F.host_node_up(plan, t)


def _check_broadcast_provenance(prov, plan, *, nbrs, received,
                                msgs_total=None, parts=None,
                                delays=None) -> tuple[bool, dict]:
    import numpy as np

    from ..tpu_sim import faults as F

    arrival, parent = prov["arrival"], prov["parent"]
    nbrs = np.asarray(nbrs)
    received = np.asarray(received, bool)
    problems: list[str] = []

    def say(msg):
        if len(problems) < 10:
            problems.append(msg)

    def cells(mask):
        # cap BEFORE formatting: a systematically broken record at
        # sweep shapes would otherwise format millions of messages
        # that say() discards past the first 10
        ii, vv = np.nonzero(mask)
        return zip(ii[:10], vv[:10])

    # reachability: every held bit has a recorded arrival
    miss = received & (arrival < 0)
    for i, v in cells(miss):
        say(f"node {i} holds value {v} with no recorded arrival")
    # tree shape: non-origin arrivals need a parent; origins (arrival
    # 0) must not claim one
    child = arrival > 0
    for i, v in cells(child & (parent < 0)):
        say(f"({i}, {v}) arrived at round {arrival[i, v]} with no "
            "parent recorded")
    for i, v in cells((arrival == 0) & (parent >= 0)):
        say(f"origin cell ({i}, {v}) claims parent {parent[i, v]}")
    # causality + edge validity over the claimed parent edges
    ii, vv = np.nonzero(child & (parent >= 0))
    pa = parent[ii, vv]
    if pa.size and (pa >= arrival.shape[0]).any():
        bad = pa >= arrival.shape[0]
        for j in np.nonzero(bad)[0][:10]:
            say(f"({ii[j]}, {vv[j]}) claims out-of-range parent "
                f"{pa[j]}")
        keep = ~bad
        ii, vv, pa = ii[keep], vv[keep], pa[keep]
    arr_c = arrival[ii, vv]
    arr_p = arrival[pa, vv]
    causal = (arr_p >= 0) & (arr_p < arr_c)
    for j in np.nonzero(~causal)[0][:10]:
        say(f"causality: ({ii[j]}, {vv[j]}) arrived at {arr_c[j]} "
            f"from parent {pa[j]} whose own arrival is {arr_p[j]}")
    # the claimed edge must exist in the topology, with liveness and
    # the loss coin re-evaluated at its send round; under per-edge
    # delays the send round is arrival - delay(edge), and the
    # receiver must also be up at the delivery round
    matched = np.zeros(ii.shape, bool)
    n_dirs = nbrs.shape[1]
    for d in range(n_dirs):
        cand = (~matched) & (nbrs[ii, d] == pa)
        if not cand.any():
            continue
        dly = (np.ones(ii.shape, np.int64) if delays is None
               else np.asarray(delays)[ii, d])
        t_send = arr_c - dly
        ok_d = cand & (t_send >= 0)
        for t in np.unique(t_send[ok_d]):
            sel = ok_d & (t_send == t)
            a, b = pa[sel], ii[sel]
            good = ~_parts_cut(parts, int(t), b, a)
            if plan is not None:
                up = _host_up(plan, int(t))
                good &= up[a] & up[b]
                good &= ~F.host_edge_drop(plan, int(t), a, b)
            idx = np.nonzero(sel)[0]
            matched[idx[good]] = True
    if plan is not None and delays is not None:
        # receiver up at the delivery round (the gather delayed path
        # masks a down receiver at delivery time)
        for t in np.unique(arr_c):
            sel = matched & (arr_c == t)
            if not sel.any():
                continue
            up = _host_up(plan, int(t) - 1)
            bad = sel & ~up[ii]
            matched[bad] = False
    for j in np.nonzero(~matched)[0][:10]:
        say(f"edge ({pa[j]} -> {ii[j]}) claimed for value {vv[j]} "
            f"at round {arr_c[j]} was not a live, un-dropped "
            "topology edge at its send round (forged parent / dead "
            "or dropped edge)")
    # tree/msgs-ledger consistency: every first delivery consumed at
    # least one value-message send.  ASSUMES the uint32 msgs ledger
    # has not wrapped (> 2^32 total sends): msgs_total arrives
    # already reduced mod 2^32, so a wrapped run is not verifiable
    # host-side — at the repo's feasible shapes (first-delivery edges
    # <= N*V << 2^32 while sends >= edges) the assumption holds long
    # before the wrap is reachable
    n_edges = int(child.sum())
    if msgs_total is not None and n_edges > msgs_total:
        say(f"tree has {n_edges} first-delivery edges but the msgs "
            f"ledger recorded only {msgs_total} sends")
    return not problems, {
        "n_arrivals": int((arrival >= 0).sum()),
        "n_tree_edges": n_edges,
        "n_origins": int((arrival == 0).sum()),
        "msgs_total": msgs_total,
        "problems": problems}


def _check_counter_provenance(prov, plan, *,
                              final_kv=None) -> tuple[bool, dict]:
    import numpy as np

    from ..tpu_sim import faults as F

    fr = prov["flush_round"]
    fk = prov["flush_kv"]
    vr = prov["visible_round"]
    problems: list[str] = []

    def say(msg):
        if len(problems) < 10:
            problems.append(msg)

    flushed = fr >= 0
    for i in np.nonzero(flushed & (fr < 1))[0]:
        say(f"node {i} flush_round {fr[i]} precedes round 1")
    if plan is not None:
        for t in np.unique(fr[flushed & (fr >= 1)]):
            kv_ok = F.host_kv_ok(plan, int(t) - 1)
            sel = flushed & (fr == t) & ~kv_ok
            for i in np.nonzero(sel)[0]:
                say(f"node {i} claims a flush at round {t} while "
                    "down or KV-dropped at its send round (forged "
                    "flush)")
    bad_kv = flushed & (fk < 1)
    for i in np.nonzero(bad_kv)[0]:
        say(f"node {i} flushed into non-positive KV value {fk[i]}")
    if final_kv is not None:
        over = flushed & (fk > int(final_kv))
        for i in np.nonzero(over)[0]:
            say(f"node {i} claims flush_kv {fk[i]} > final KV "
                f"{final_kv} (the KV is monotone)")
    early = (vr >= 0) & (vr < fr)
    for i in np.nonzero(early)[0]:
        say(f"node {i} visible at {vr[i]} before its flush at "
            f"{fr[i]}")
    for i in np.nonzero((vr >= 0) & (fr < 0))[0]:
        say(f"node {i} visible at {vr[i]} with no flush recorded")
    return not problems, {
        "n_flushed": int(flushed.sum()),
        "n_visible": int((vr >= 0).sum()),
        "final_kv": final_kv,
        "problems": problems}


def _check_kafka_provenance(prov, plan, *, n_nodes,
                            resync_every=4, resync_mode="pull",
                            witness=0) -> tuple[bool, dict]:
    import numpy as np

    from ..tpu_sim import faults as F

    ar = prov["alloc_round"]
    og = prov["origin"]
    fp = prov["first_present"]
    problems: list[str] = []

    def say(msg):
        if len(problems) < 10:
            problems.append(msg)

    alloc = ar >= 1
    for k, c in zip(*np.nonzero((ar == 0) | ((ar < 0) & (og >= 0)))):
        say(f"slot ({k}, {c}) has inconsistent alloc stamps "
            f"round={ar[k, c]} origin={og[k, c]}")

    # vectorized over the allocated slots, host coins memoized PER
    # ROUND (the coins are pure functions of t — a per-slot loop
    # would re-evaluate the O(N) arrays slots times; at the sweep
    # shapes that is minutes of checker for a seconds-long run)
    ks, cs = np.nonzero(alloc)
    o = og[ks, cs].astype(np.int64)
    t_all = ar[ks, cs].astype(np.int64)
    t_fp = fp[ks, cs].astype(np.int64)

    def complain(mask, msg_fn):
        for i in np.nonzero(mask)[0][:10]:
            say(msg_fn(int(ks[i]), int(cs[i]), i))

    bad_o = (o < 0) | (o >= n_nodes)
    complain(bad_o, lambda k, c, i:
             f"slot ({k}, {c}) claims out-of-range origin {o[i]}")
    live = ~bad_o
    oc = np.clip(o, 0, n_nodes - 1)
    if plan is not None:
        kv_ok_at = {int(t): F.host_kv_ok(plan, int(t))
                    for t in np.unique(t_all[live] - 1)}
        forged = live.copy()
        for t, kv_ok in kv_ok_at.items():
            sel = live & (t_all - 1 == t)
            forged[sel] = ~kv_ok[oc[sel]]
        forged &= live
        complain(forged, lambda k, c, i:
                 f"slot ({k}, {c}) claims allocation by node {o[i]} "
                 f"at round {t_all[i]} while down or KV-dropped "
                 "(forged allocation)")
        live &= ~forged
    never = live & (t_fp < 0)
    complain(never, lambda k, c, i:
             f"allocated slot ({k}, {c}) never became present at "
             f"witness {witness}")
    early = live & (t_fp >= 0) & (t_fp < t_all)
    complain(early, lambda k, c, i:
             f"slot ({k}, {c}) present at witness round {t_fp[i]} "
             f"BEFORE its allocation at {t_all[i]}")
    live &= ~(never | early)
    at_wit = live & (o == witness)
    complain(at_wit & (t_fp != t_all), lambda k, c, i:
             f"slot ({k}, {c}) originated AT the witness but "
             f"first_present {t_fp[i]} != alloc {t_all[i]}")
    direct = live & ~at_wit & (t_fp == t_all)
    resync = live & ~at_wit & (t_fp > t_all)
    n_direct = int(direct.sum())
    n_resync = int(resync.sum())
    if plan is not None and direct.any():
        bad_dir = np.zeros(direct.shape, bool)
        for t in np.unique(t_all[direct] - 1):
            t = int(t)
            sel = direct & (t_all - 1 == t)
            up = _host_up(plan, t)
            # the anti-entropy resync runs INSIDE the round after
            # delivery, so an alloc at a resync round can reach the
            # witness the same round even when the direct replicate
            # coin dropped (pull: the union includes the up origin's
            # own copy; push: origin_bits gains the append before
            # the push) — witness must be up
            same_rs = t > 0 and t % resync_every == 0 and up[witness]
            if same_rs:
                continue
            drop = F.host_edge_drop(
                plan, t, oc[sel], np.full(int(sel.sum()), witness))
            bad_dir[np.nonzero(sel)[0]] = ~up[witness] | drop
        complain(bad_dir, lambda k, c, i:
                 f"slot ({k}, {c}) claims a direct replicate "
                 f"({o[i]} -> {witness}) at round {t_all[i]} on a "
                 "dead or dropped edge (forged delivery)")
    if resync.any():
        t2 = t_fp - 1
        not_rs = resync & ~((t2 > 0) & (t2 % resync_every == 0))
        complain(not_rs, lambda k, c, i:
                 f"slot ({k}, {c}) late witness presence at round "
                 f"{t_fp[i]} is not a resync round (resync_every="
                 f"{resync_every})")
        if plan is not None:
            ok_rs = resync & ~not_rs
            for t in np.unique(t2[ok_rs]):
                t = int(t)
                sel = ok_rs & (t2 == t)
                up2 = _host_up(plan, t)
                if not up2[witness]:
                    complain(sel, lambda k, c, i:
                             f"slot ({k}, {c}) claims a resync "
                             f"delivery at round {t_fp[i]} while "
                             "the witness was down")
                elif resync_mode == "push":
                    dead_o = sel & ~up2[oc]
                    complain(dead_o, lambda k, c, i:
                             f"slot ({k}, {c}) claims a push-resync "
                             f"from origin {o[i]} at round "
                             f"{t_fp[i]} while the origin was down")
    return not problems, {
        "n_allocated": int(alloc.sum()),
        "n_direct": n_direct,
        "n_resync": n_resync,
        "witness": witness,
        "problems": problems}


def check_txn_serializable(history: list, *, final: dict | None = None,
                           max_problems: int = 10
                           ) -> tuple[bool, dict]:
    """Serializability certification for a txn-rw-register history
    (tpu_sim/txn.py ``history_of``) — the host-side cycle check over
    the device-recorded read/write version graph.

    Each entry: ``{id, status, commit_round, ops: [{kind 'r'/'w',
    key, ver, val}]}`` where a write op's ``ver`` is the version it
    INSTALLED and a read op's ``ver``/``val`` are what it observed.
    The checker is falsifiable by construction (tests plant each
    anomaly and every verdict names the offending transaction ids):

    - **lost update**: two committed writes install the same
      ``(key, version)`` — on device this is exactly what
      ``kv_amnesia`` owner wipes produce (versions reset, a later
      commit re-installs an already-acked slot).
    - **G1a aborted read**: a committed read observes a value written
      by a transaction that never committed.
    - **G1b intermediate read**: a committed read of ``(key, ver)``
      observes a value different from what the committed writer of
      that version installed.
    - **write cycle**: the ww/wr/rw dependency graph over committed
      transactions has a cycle — not serializable.
    - **round-order violation**: a dependency edge runs BACKWARD in
      commit rounds.  The tentpole's linearization claim is that the
      serialization order IS the round order ``(commit_round, node)``;
      any edge ``u -> v`` with ``commit_round(u) > commit_round(v)``
      falsifies it even before a full cycle closes.

    ``final``: optional ``{key: (value, version)}`` store snapshot
    (tpu_sim/txn.py ``final_registers``) — the final version of every
    key must be the maximum committed installed version and carry that
    writer's value, else an acked commit was lost from the store.

    The reference's result, with the same dependency edges added in the
    same order; its per-key scan of every reader is done once, grouped by
    key, and a cycle found once ``max_problems`` problems are listed is
    counted in ``by_kind`` without being built (the reference builds each
    and drops it from the list).
    """
    problems: list = []
    by_kind: dict = {}

    def add(kind, txns, **kw):
        by_kind[kind] = by_kind.get(kind, 0) + 1
        problems.append(dict(kind=kind, txns=sorted(txns), **kw))

    committed = {h["id"]: h for h in history
                 if h["status"] == "committed"}
    # writers[(key, ver)] -> [(txn, val)]; lost update = len > 1
    writers: dict = {}
    aborted_writes: dict = {}   # (key, val) -> txn (non-committed)
    for h in history:
        for op in h.get("ops", ()):
            if op["kind"] != "w":
                continue
            if h["status"] == "committed":
                writers.setdefault((op["key"], op["ver"]),
                                   []).append((h["id"], op["val"]))
            else:
                aborted_writes[(op["key"], op["val"])] = h["id"]
    for (key, ver), ws in sorted(writers.items()):
        if len(ws) > 1:
            add("lost-update", [t for t, _ in ws], key=key, ver=ver)

    # read anomalies
    for h in committed.values():
        for op in h["ops"]:
            if op["kind"] != "r":
                continue
            key, ver, val = op["key"], op["ver"], op["val"]
            ws = writers.get((key, ver))
            if ws is not None:
                if all(val != wval for _, wval in ws):
                    add("G1b-intermediate-read",
                        [h["id"]] + [t for t, _ in ws],
                        key=key, ver=ver, saw=val,
                        committed=[wval for _, wval in ws])
            elif ver > 0 or val != 0:
                writer = aborted_writes.get((key, val))
                if writer is not None:
                    add("G1a-aborted-read", [h["id"], writer],
                        key=key, ver=ver, val=val)
                else:
                    add("dangling-version-read", [h["id"]],
                        key=key, ver=ver, val=val)

    # dependency graph over committed txns: ww (version order),
    # wr (writer -> observer), rw (observer -> next writer)
    by_key_vers: dict = {}
    for (key, ver), ws in writers.items():
        by_key_vers.setdefault(key, {})[ver] = ws[0][0]
    readers: dict = {}          # (key, ver) -> [txn]
    for h in committed.values():
        for op in h["ops"]:
            if op["kind"] == "r":
                readers.setdefault((op["key"], op["ver"]),
                                   []).append(h["id"])
    # each key's read versions, in the readers' order (the reference
    # scans every reader for each key: quadratic at 2^16 nodes)
    read_vers: dict = {}
    for k, v in readers:
        read_vers.setdefault(k, []).append(v)
    edges: set = set()
    for key in {k for k, _ in list(writers) + list(readers)}:
        vers = by_key_vers.get(key, {})
        order = sorted(vers)
        for a, b in zip(order, order[1:]):
            edges.add((vers[a], vers[b]))                     # ww
        seen_vers = set(order) | {v for v in read_vers.get(key, ())}
        for ver in seen_vers:
            rds = readers.get((key, ver), ())
            if ver in vers:
                for r in rds:
                    edges.add((vers[ver], r))                 # wr
            nxt = bisect.bisect_right(order, ver)
            if nxt < len(order) and rds:    # rw: observer -> the next
                for r in rds:               # writer (incl. reads of
                    edges.add((r, vers[order[nxt]]))  # the initial v0)
    edges = {(u, v) for u, v in edges if u != v}

    for u, v in sorted(edges):
        cu = committed[u]["commit_round"]
        cv = committed[v]["commit_round"]
        if cu >= 0 and cv >= 0 and cu > cv:
            add("round-order-violation", [u, v],
                rounds=(cu, cv))

    # cycle check (iterative colored DFS; report one cycle's ids)
    adj: dict = {}
    for u, v in edges:
        adj.setdefault(u, []).append(v)
    color = {t: 0 for t in committed}           # 0 white 1 grey 2 black
    for root in sorted(committed):
        if color.get(root, 2) != 0:
            continue
        stack = [(root, iter(adj.get(root, ())))]
        color[root] = 1
        path = [root]
        pos = {root: 0}                 # each grey node's place in path
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if color.get(nxt, 2) == 0:
                    color[nxt] = 1
                    pos[nxt] = len(path)
                    path.append(nxt)
                    stack.append((nxt, iter(adj.get(nxt, ()))))
                    break
                if color.get(nxt) == 1:
                    if 0 <= max_problems <= len(problems):
                        # past the reported problems: counted, not built
                        by_kind["write-cycle"] = \
                            by_kind.get("write-cycle", 0) + 1
                    else:
                        cyc = path[pos[nxt]:] + [nxt]
                        add("write-cycle", set(cyc), cycle=cyc)
                    color[nxt] = 2      # report each cycle once
            else:
                stack.pop()
                del pos[path.pop()]
                color[node] = 2

    # final-state anchor: no acked commit may vanish from the store
    if final is not None:
        for key, (fval, fver) in sorted(final.items()):
            vers = by_key_vers.get(key, {})
            top = max(vers) if vers else 0
            if fver != top:
                add("lost-acked-commit",
                    [vers[v] for v in vers if v > fver] or
                    ([vers[top]] if vers else []),
                    key=key, final_ver=fver, max_committed_ver=top)
            elif vers:
                want = next(wval for t, wval in writers[(key, top)]
                            if t == vers[top])
                if fval != want:
                    add("final-value-mismatch", [vers[top]], key=key,
                        final_val=fval, committed_val=want)

    return not by_kind, {
        "n_txns": len(history), "n_committed": len(committed),
        "n_edges": len(edges), "by_kind": by_kind,
        "problems": problems[:max_problems]}
