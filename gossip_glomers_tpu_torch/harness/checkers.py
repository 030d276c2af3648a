"""The serving runner's checkers: a partial copy of
gossip_glomers_tpu/harness/checkers.py (``check_recovery``,
``check_op_latency``, ``check_telemetry`` and the helper
``series_divergence_round`` they need), kept as the reference has them
(tests/test_torch_serving.py holds each equal to the original on seeded
inputs).  The rest of that module waits for the port's runners (ROADMAP.md
Queue A item 13).

Each checker returns ``(ok, details)``.
"""

from __future__ import annotations


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
