"""The fault-space fuzzer on PyTorch: the port of
gossip_glomers_tpu/harness/fuzz.py — thousands of certified crash x loss
x dup x partition x delay x membership campaigns, and an auto-shrunk
repro for every failure.

1. **sample**: :func:`sample_scenarios` draws scenario cells from a
   seeded generator over the fault axes (crash windows, loss rate, dup
   rate, partition windows and per-edge delays for broadcast, membership
   churn), each a JSON-able :class:`..tpu_sim.scenario.Scenario`;
2. **dispatch**: :func:`fuzz_run` packs them into scenario batches
   (:class:`..tpu_sim.scenario.ScenarioBatch`) and certifies each one
   (``run_scenario_batch`` on ``device``, CUDA unless given);
3. **repro**: every failing scenario is re-run through its sequential
   runner with telemetry on (the batches equal the sequential runners, so
   the failure reproduces), and the flight recorder writes its bundle;
4. **shrink**: :func:`shrink_scenario` greedily reduces the failing cell,
   accepting a move only when the reduced cell still fails with the same
   signature; the result carries a minimality certificate (removing any
   kept component makes the failure vanish or moves the replayed
   trajectory) and a check that the shrunk bundle replays to the same
   failure from its JSON alone.

Everything is a pure function of the fuzzer seed.  ``shape_buckets``
compiles nothing in PyTorch: it pads the batches exactly as the reference
does and ``n_program_shapes`` counts the same distinct batch shapes.
``mesh=`` (a :class:`..parallel.mesh.Mesh`, every rank calling) places
each batch over the ranks (:func:`..tpu_sim.scenario.
dispatch_scenario_batch`) and runs the repro, the shrinker's candidate
runs and the replay on the mesh's sims (the runners' ``mesh=``), so
every rank returns the same campaign and rank 0 writes the bundles.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from ..tpu_sim import scenario as SC
from ..tpu_sim import telemetry as TM
from ..tpu_sim.faults import NemesisSpec, random_spec

# the sampled axis grids (each cell draws one value per axis)
LOSS_GRID = (0.0, 0.05, 0.1, 0.2)
DUP_GRID = (0.0, 0.05, 0.1)
CRASH_GRID = (0, 1, 2)
DELAY_CLASSES = (1, 2)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (the shape-bucket rounding)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _axis_key(sc: "SC.Scenario") -> tuple:
    """The fault-space grid cell one sampled scenario came from —
    the adaptive fuzzer's steering granularity (CoverageMap axis),
    computable BEFORE the run: the sampled grid values (crash
    windows, loss rate, dup rate, partition windows, max delay
    class) refined by the crash shape (earliest-start bucket, total
    crashed nodes) — timing and blast radius drive which behavior a
    scenario lands in, so the axis must distinguish them or the
    steering chases the wrong cells."""
    spec = sc.spec
    starts = [s for s, _e, _ns in spec.crash]
    return (len(spec.crash),
            float(spec.loss_rate or 0.0),
            float(spec.dup_rate or 0.0),
            0 if sc.parts is None else len(sc.parts["starts"]),
            0 if sc.delays is None
            else max(v for row in sc.delays for v in row),
            min(starts) // 2 if starts else -1,
            sum(len(ns) for _s, _e, ns in spec.crash),
            # membership churn shape: joined/left node counts
            # — the steering axis behind the signature's churn bucket
            sum(len(ns) for _r, ns in spec.join),
            sum(len(ns) for _r, ns in spec.leave))


# -- sampling ------------------------------------------------------------


def _sample_partition(rng, n_nodes: int, horizon: int) -> dict:
    """One random bipartition window inside the horizon (JSON meta)."""
    s = int(rng.integers(1, max(2, horizon - 2)))
    e = int(rng.integers(s + 1, horizon + 1))
    group = (rng.random(n_nodes) < 0.5).astype(np.int8)
    # both sides non-empty, else the window is inert
    if group.all() or not group.any():
        group[0] = 1 - group[0]
    return {"starts": [s], "ends": [e],
            "group": [group.astype(int).tolist()]}


def _sample_membership(rng, spec: NemesisSpec,
                       horizon: int) -> NemesisSpec:
    """Draw this cell's membership churn: scattered joins and
    leaves on non-crash rows, or a resize-shaped BLOCK (a contiguous
    row block joining or leaving at one round — the in-place form of
    an elastic grow/shrink, often crossing an active crash window).
    Roughly a third of cells stay churn-free so the no-membership
    fast path keeps getting fuzzed too.

    Leaves land ``n_nodes + 2`` rounds past the spec's fault clear: a
    leave is permanent, so the workload's anti-entropy must have
    replicated the row's uniquely-held acked state first — the fuzz
    grid measures recovery under churn, not the guaranteed
    ack-before-replication loss (the same convention as the counter
    crash-window shift above; tests plant early leaves deliberately
    to watch the checker name the loss)."""
    n = spec.n_nodes
    crash_rows = {i for _s, _e, ns in spec.crash for i in ns}
    free = [i for i in range(n) if i not in crash_rows]
    shape = rng.random()
    base_clear = spec.clear_round
    leave_at = base_clear + n + 2 + int(rng.integers(0, 3))
    join: tuple = ()
    leave: tuple = ()
    if shape < 0.2 and len(free) >= 2:
        # scattered churn: 1-2 joiners early, 0-1 leaver late
        k = int(rng.integers(1, 3))
        rows = [int(i) for i in rng.choice(free, size=min(k + 1,
                                                          len(free)),
                                           replace=False)]
        jr = int(rng.integers(1, max(2, 3 * horizon // 4) + 1))
        join = ((jr, tuple(sorted(rows[:k]))),)
        if len(rows) > k and rng.random() < 0.5:
            leave = ((leave_at, (rows[k],)),)
    elif shape < 0.4 and len(free) >= 4:
        # resize-shaped block churn: a contiguous block of the padded
        # axis joins (grow) or leaves (shrink) at ONE round — the
        # crash windows the generator placed keep running across it
        blk = int(rng.integers(2, max(3, len(free) // 2) + 1))
        rows = tuple(sorted(free))[-blk:]
        if rng.random() < 0.5:
            jr = int(rng.integers(1, max(2, 3 * horizon // 4) + 1))
            join = ((jr, rows),)
        else:
            leave = ((leave_at, rows),)
    else:
        return spec
    meta = spec.to_meta()
    meta["join"] = [[r, list(ns)] for r, ns in join]
    meta["leave"] = [[r, list(ns)] for r, ns in leave]
    return NemesisSpec.from_meta(meta)


def sample_scenarios(workload: str, n_scenarios: int, *,
                     n_nodes: int, seed: int, horizon: int,
                     nbrs_shape=None, delay_axis: bool = False,
                     partition_axis: bool = True,
                     membership_axis: bool = False) -> list:
    """Seeded scenario cells over the fault-space grid.  Scenario
    ``i``'s spec seed is ``seed * 100003 + i`` — distinct seeds,
    bit-replayable.  ``delay_axis`` samples per-edge delays over
    ``DELAY_CLASSES`` for EVERY cell (batches must be homogeneous in
    the delay dimension — the delays-on round carries a history
    ring); ``nbrs_shape`` is the (N, D) adjacency shape the delay
    matrix must match; ``membership_axis`` additionally draws join /
    leave / resize-shaped block churn per cell
    (:func:`_sample_membership` — stateful workloads only: the txn
    runner has no membership-aware liveness gate yet and rejects
    membership-bearing plans loudly)."""
    if delay_axis and nbrs_shape is None:
        raise ValueError("delay_axis sampling needs nbrs_shape")
    if membership_axis and workload == "txn":
        raise ValueError(
            "membership churn is not wired for the txn workload: its "
            "wound-or-die CAS rows re-home on resize and the runner "
            "has no membership-aware liveness gate — fuzz txn at "
            "fixed membership")
    out = []
    for i in range(n_scenarios):
        cell_seed = seed * 100003 + i
        rng = np.random.default_rng(cell_seed)
        n_crash = int(rng.choice(CRASH_GRID))
        loss = float(rng.choice(LOSS_GRID))
        dup = (float(rng.choice(DUP_GRID))
               if workload == "broadcast" else 0.0)
        if n_crash == 0:
            spec = NemesisSpec(
                n_nodes=n_nodes, seed=cell_seed, loss_rate=loss,
                loss_until=horizon if loss else None,
                dup_rate=dup, dup_until=horizon if dup else None)
        else:
            spec = random_spec(
                n_nodes, seed=cell_seed, horizon=horizon,
                n_crash_windows=n_crash, loss_rate=loss,
                dup_rate=dup)
        if workload == "counter" and spec.crash:
            # the sweep's counter convention (fault_sweep._shift_crash):
            # the cas flush drains one contender per round, so a crash
            # window landing before round N provably kills
            # acked-but-unflushed deltas — the ack-before-durability
            # loss the certifier exists to flag, but a RECOVERY fuzz
            # grid should measure recovery, not guaranteed loss
            shift = n_nodes + 2
            meta = spec.to_meta()
            meta["crash"] = [[s + shift, e + shift, ns]
                             for s, e, ns in meta["crash"]]
            if spec.loss_rate:
                meta["loss_until"] += shift
            if spec.dup_rate:
                meta["dup_until"] += shift
            spec = NemesisSpec.from_meta(meta)
        if membership_axis:
            # after the counter shift: the leave margin is computed
            # from the (shifted) fault clear round
            spec = _sample_membership(rng, spec, horizon)
        parts = None
        delays = None
        if workload == "broadcast":
            if partition_axis and rng.random() < 0.5:
                parts = _sample_partition(rng, n_nodes, horizon)
            if delay_axis:
                d = rng.choice(DELAY_CLASSES,
                               size=nbrs_shape).astype(np.int32)
                delays = tuple(tuple(int(v) for v in row)
                               for row in d)
        out.append(SC.Scenario(spec=spec, parts=parts, delays=delays,
                               workload_seed=cell_seed))
    return out


def planted_failure(workload: str, n_nodes: int,
                    horizon: int) -> SC.Scenario:
    """A scenario that PROVABLY fails: a crash window opening at round
    0 takes the sole copies its nodes hold down with them (broadcast:
    origin values wiped before the first flood — lost acked writes),
    dressed with non-load-bearing loss/dup/partition components the
    shrinker must strip."""
    if workload in ("kafka", "txn"):
        raise ValueError(
            "the planted-failure cell targets broadcast/counter "
            "(kafka allocations require a live origin, and txn "
            "commits survive crashes by wound-or-die retry — plant "
            "txn anomalies via kv_amnesia or the checker's planted "
            "histories instead)")
    spec = NemesisSpec(
        n_nodes=n_nodes, seed=424242,
        crash=((0, horizon, (0, 1)),),
        loss_rate=0.1, loss_until=horizon,
        dup_rate=0.05 if workload == "broadcast" else 0.0,
        dup_until=horizon if workload == "broadcast" else None)
    parts = None
    if workload == "broadcast":
        group = (np.arange(n_nodes) % 2).astype(int)
        parts = {"starts": [1], "ends": [3],
                 "group": [group.tolist()]}
    return SC.Scenario(spec=spec, parts=parts,
                       workload_seed=424242)


# -- failure signatures & spec weight ------------------------------------


def _canon_lost(lost) -> tuple:
    """Canonical JSON-stable form of a lost-writes evidence list
    (entries survive a bundle's JSON round trip: tuples become
    lists)."""
    def canon(e):
        if isinstance(e, (list, tuple)):
            return json.dumps([canon(x) for x in e])
        if isinstance(e, dict):
            return json.dumps(
                {k: canon(v) for k, v in sorted(e.items())})
        return json.dumps(e)

    return tuple(sorted(canon(e) for e in lost))


def failure_signature(result: dict) -> dict | None:
    """What makes two failures "the same" for the shrinker: the
    workload, whether the run converged at all, and the canonical
    lost-writes evidence.  None for a PASSING run (nothing to
    shrink)."""
    if result.get("ok"):
        return None
    return {"workload": result.get("workload"),
            "converged": result.get("converged_round") is not None,
            "n_lost": result.get("n_lost_writes", 0),
            "lost": _canon_lost(result.get("lost_writes", []))}


def scenario_weight(sc: SC.Scenario) -> int:
    """Size metric the shrinker drives down: crash windows + crashed
    nodes + window rounds + active rates/horizons + partition windows
    + non-unit delay edges.  A shrunk repro must weigh strictly less
    than its original."""
    spec = sc.spec
    w = 0
    for s, e, nodes in spec.crash:
        w += 1 + len(nodes) + (e - s)
    if spec.loss_rate > 0:
        w += 1 + spec._until(spec.loss_until, spec.loss_rate)
    if spec.dup_rate > 0:
        w += 1 + spec._until(spec.dup_until, spec.dup_rate)
    if sc.parts is not None:
        w += len(sc.parts["starts"])
    if sc.delays is not None:
        w += int(sum(1 for row in sc.delays for v in row if v != 1))
    for _r, nodes in spec.join:
        w += 2 + len(nodes)
    for _r, nodes in spec.leave:
        w += 2 + len(nodes)
    return w


# -- sequential repro ----------------------------------------------------


def run_sequential(workload: str, sc: SC.Scenario, runner_kw: dict,
                   max_recovery_rounds: int, *, telemetry=None,
                   observe_dir=None, device=None, mesh=None) -> dict:
    """One scenario through the ordinary ``run_*_nemesis`` runner on
    ``device`` (or ``mesh``, every rank calling): the repro and shrink
    path (the batches equal it)."""
    from . import nemesis as NM

    kw = dict(runner_kw)
    place = dict(device=device) if mesh is None else dict(mesh=mesh)
    if workload == "broadcast":
        return NM.run_broadcast_nemesis(
            sc.spec, n_values=kw.get("n_values"),
            topology=kw.get("topology", "grid"),
            sync_every=int(kw.get("sync_every", 4)),
            parts=sc.parts,
            delays=(None if sc.delays is None
                    else np.asarray(sc.delays, np.int32)),
            max_recovery_rounds=max_recovery_rounds,
            telemetry=telemetry, observe_dir=observe_dir, **place)
    if workload == "counter":
        return NM.run_counter_nemesis(
            sc.spec, mode=kw.get("mode", "cas"),
            poll_every=int(kw.get("poll_every", 2)),
            max_recovery_rounds=max_recovery_rounds,
            telemetry=telemetry, observe_dir=observe_dir, **place)
    if workload == "txn":
        from . import txn as TXH
        return TXH.run_txn_nemesis(
            sc.spec, n_keys=int(kw.get("n_keys", 8)),
            txns_per_node=int(kw.get("txns_per_node", 4)),
            ops_per_txn=int(kw.get("ops_per_txn", 2)),
            rate=float(kw.get("rate", 0.5)),
            until=kw.get("until"),
            kv_amnesia=bool(kw.get("kv_amnesia", False)),
            workload_seed=sc.workload_seed,
            max_recovery_rounds=max_recovery_rounds,
            telemetry=telemetry, observe_dir=observe_dir, **place)
    return NM.run_kafka_nemesis(
        sc.spec, n_keys=int(kw.get("n_keys", 4)),
        capacity=int(kw.get("capacity", 64)),
        max_sends=int(kw.get("max_sends", 2)),
        resync_every=int(kw.get("resync_every", 4)),
        workload_seed=sc.workload_seed, commits=False,
        send_prob=float(kw.get("send_prob", 0.7)),
        rounds=kw.get("rounds"),
        max_recovery_rounds=max_recovery_rounds,
        telemetry=telemetry, observe_dir=observe_dir, **place)


# -- the auto-shrinker ---------------------------------------------------


def _shrink_moves(sc: SC.Scenario):
    """Candidate reductions of one scenario, most-aggressive first.
    Every move yields ``(description, reduced Scenario)``; the greedy
    loop accepts a move iff the reduced cell still fails with the
    identical signature."""
    spec = sc.spec
    meta = spec.to_meta()

    def with_spec(m):
        return SC.Scenario(spec=NemesisSpec.from_meta(m),
                           parts=sc.parts, delays=sc.delays,
                           workload_seed=sc.workload_seed)

    # drop whole crash windows
    for i in range(len(meta["crash"])):
        m = dict(meta)
        m["crash"] = [w for j, w in enumerate(meta["crash"])
                      if j != i]
        yield f"drop crash window {i}", with_spec(m)
    # drop individual crashed nodes
    for i, (s, e, nodes) in enumerate(meta["crash"]):
        if len(nodes) <= 1:
            continue
        for j in range(len(nodes)):
            m = dict(meta)
            m["crash"] = [list(w) for w in meta["crash"]]
            m["crash"][i] = [s, e,
                             [x for k, x in enumerate(nodes)
                              if k != j]]
            yield (f"drop node {nodes[j]} from crash window {i}",
                   with_spec(m))
    # halve crash-window durations (toward 1 round)
    for i, (s, e, nodes) in enumerate(meta["crash"]):
        if e - s > 1:
            m = dict(meta)
            m["crash"] = [list(w) for w in meta["crash"]]
            m["crash"][i] = [s, s + max(1, (e - s) // 2), list(nodes)]
            yield (f"halve crash window {i} duration", with_spec(m))
    # zero, then halve, the loss/dup rates
    for rate_key, until_key in (("loss_rate", "loss_until"),
                                ("dup_rate", "dup_until")):
        if meta[rate_key] > 0:
            m = dict(meta)
            m[rate_key] = 0.0
            m[until_key] = None
            yield f"zero {rate_key}", with_spec(m)
            m2 = dict(meta)
            m2[rate_key] = meta[rate_key] / 2
            yield f"halve {rate_key}", with_spec(m2)
    # drop whole membership events — a node left join-only or
    # leave-only stays a valid spec (a founding node may leave; a
    # joined node may stay forever)
    for key in ("join", "leave"):
        for i in range(len(meta[key])):
            m = dict(meta)
            m[key] = [e for j, e in enumerate(meta[key]) if j != i]
            yield f"drop {key} event {i}", with_spec(m)
    # halve resize-shaped block deltas: keep the event, shed half its
    # rows — the membership mirror of the crash-window node drops
    for key in ("join", "leave"):
        for i, (r, nodes) in enumerate(meta[key]):
            if len(nodes) <= 1:
                continue
            m = dict(meta)
            m[key] = [list(e) for e in meta[key]]
            m[key][i] = [r, list(nodes)[:max(1, len(nodes) // 2)]]
            yield f"halve {key} event {i} block", with_spec(m)
    # drop partition windows
    if sc.parts is not None:
        n_w = len(sc.parts["starts"])
        for i in range(n_w):
            if n_w == 1:
                reduced = None
            else:
                reduced = {
                    "starts": [v for j, v in
                               enumerate(sc.parts["starts"]) if j != i],
                    "ends": [v for j, v in
                             enumerate(sc.parts["ends"]) if j != i],
                    "group": [g for j, g in
                              enumerate(sc.parts["group"]) if j != i]}
            yield (f"drop partition window {i}",
                   SC.Scenario(spec=spec, parts=reduced,
                               delays=sc.delays,
                               workload_seed=sc.workload_seed))
    # flatten the delay matrix to uniform 1 (drop the delay axis)
    if sc.delays is not None \
            and any(v != 1 for row in sc.delays for v in row):
        ones = tuple(tuple(1 for _ in row) for row in sc.delays)
        yield ("flatten delays to 1",
               SC.Scenario(spec=spec, parts=sc.parts, delays=ones,
                           workload_seed=sc.workload_seed))


def _components(sc: SC.Scenario):
    """The retained fault components of a (shrunk) scenario, each with
    the scenario-with-it-removed — the minimality certificate re-runs
    every one."""
    for desc, cand in _shrink_moves(sc):
        # removal moves only (halving is a reduction, not a removal)
        if desc.startswith(("drop", "zero", "flatten")):
            yield desc, cand


def shrink_scenario(workload: str, sc: SC.Scenario, runner_kw: dict,
                    max_recovery_rounds: int, *, observe_dir,
                    tel_rounds: int, max_iters: int = 200,
                    device=None, mesh=None) -> dict:
    """Greedy auto-shrink of one failing scenario (module docstring).
    Returns the shrink record: original/shrunk cells + weights, the
    accepted move trail, the shrunk cell's flight bundle path, the
    per-component minimality certificate, and the final
    replay-from-JSON verdict.  ``mesh``: every run (candidates, bundle,
    replay) on the mesh's sims, every rank calling."""
    from . import observe
    from .checkers import series_divergence_round

    # txn has no telemetry ring — its bundles carry the per-txn
    # stamp record instead, and the replay diffs those for the
    # first-divergence round
    tel_spec = (None if workload == "txn"
                else TM.TelemetrySpec(workload, rounds=tel_rounds))
    base = run_sequential(workload, sc, runner_kw,
                          max_recovery_rounds, device=device, mesh=mesh)
    sig0 = failure_signature(base)
    if sig0 is None:
        raise ValueError(
            "shrink_scenario needs a FAILING scenario (the batch "
            "verdict said this one failed but the sequential rerun "
            "passed — a batch/sequential divergence, which the parity "
            "tests pin against)")
    cur = sc
    trail = []
    iters = 0
    progress = True
    while progress and iters < max_iters:
        progress = False
        for desc, cand in _shrink_moves(cur):
            iters += 1
            if iters > max_iters:
                break
            res = run_sequential(workload, cand, runner_kw,
                                 max_recovery_rounds, device=device,
                                 mesh=mesh)
            if failure_signature(res) == sig0:
                cur = cand
                trail.append(desc)
                progress = True
                break
    # the shrunk cell's own bundle (telemetry on, so the bundle
    # carries the series the divergence checks diff against)
    shrunk_res = run_sequential(workload, cur, runner_kw,
                                max_recovery_rounds,
                                telemetry=tel_spec,
                                observe_dir=observe_dir, device=device,
                                mesh=mesh)
    if failure_signature(shrunk_res) != sig0:
        raise AssertionError(
            "shrunk scenario changed its failure under telemetry — "
            "the observed drivers are pinned bit-exact, so this is a "
            "recorder bug")
    bundle_path = shrunk_res.get("flight_bundle")
    bundle = observe.load_bundle(bundle_path)
    # minimality: removing ANY retained component must make the
    # failure vanish or visibly move the trajectory against the
    # shrunk bundle's recorded series
    minimality = []
    for desc, cand in _components(cur):
        res = run_sequential(workload, cand, runner_kw,
                             max_recovery_rounds, telemetry=tel_spec,
                             device=device, mesh=mesh)
        changed = failure_signature(res) != sig0
        div = None
        series = (res.get("telemetry") or {}).get("series")
        if bundle.get("telemetry_series") and series:
            div = series_divergence_round(
                bundle["telemetry_series"], series)
        minimality.append({
            "component": desc,
            "load_bearing": bool(changed or div is not None),
            "ok_after_removal": bool(res["ok"]),
            "signature_changed": bool(changed),
            "first_divergence_round": div,
        })
    # the repro contract: the shrunk bundle replays to the SAME
    # failure from its JSON alone, with a faithful (divergence-free)
    # record
    replay = observe.replay_bundle(bundle_path, device=device, mesh=mesh)
    replay_ok = (not replay["ok"]
                 and failure_signature(replay) == sig0
                 and replay.get("first_divergence_round") is None)
    return {
        "workload": workload,
        "original": sc.to_meta(),
        "shrunk": cur.to_meta(),
        "weight_before": scenario_weight(sc),
        "weight_after": scenario_weight(cur),
        "signature": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in sig0.items()},
        "moves_accepted": trail,
        "n_candidate_runs": iters,
        "bundle": bundle_path,
        "minimality": minimality,
        "all_components_load_bearing": all(
            m["load_bearing"] for m in minimality),
        "replay_same_failure": bool(replay_ok),
    }


# -- the fuzzer ----------------------------------------------------------


def fuzz_run(workload: str = "broadcast", n_scenarios: int = 256, *,
             n_nodes: int = 24, batch_size: int = 64,
             horizon: int = 8, max_recovery_rounds: int = 32,
             seed: int = 0, mesh=None, runner_kw: dict | None = None,
             delay_axis: str = "alternate",
             membership_axis: bool = False,
             plant_failure: bool = False,
             shrink: bool = True, max_shrinks: int | None = None,
             observe_dir: str | None = None,
             shape_buckets: bool = False,
             pipeline: bool = False,
             signatures: bool = False,
             adapt: bool = False,
             adapt_oversample: int = 4,
             coverage=None,
             device=None,
             ) -> dict:
    """The fault-space fuzzer (module docstring): sample
    ``n_scenarios`` cells, certify them in ``batch_size``-scenario
    batches, emit a flight bundle + auto-shrunk minimal repro for every
    failure.

    ``delay_axis`` (broadcast): ``"alternate"`` — every other batch
    samples per-edge delays (batches are homogeneous in the delay
    dimension); ``"on"`` / ``"off"`` force it.  ``membership_axis``
    draws join/leave/resize-block churn per cell; with
    ``adapt=True`` the signature's fifth field (the churn bucket)
    steers the budget toward axis cells still producing novel churn
    behaviors.  ``plant_failure`` prepends :func:`planted_failure`
    (a provably failing cell): the end-to-end shrink probe.

    Knobs, all off by default:

    - ``shape_buckets``: pad every batch to power-of-two shapes
      (crash-window count, scenario count via ``pad_to``, a
      campaign-wide trip-count floor via ``min_rounds``), as the
      reference does to reuse one compiled program (rows unchanged);
    - ``pipeline``: depth 2 — batch ``i+1`` is dispatched before batch
      ``i``'s results are collected (verdicts identical);
    - ``signatures``: record each scenario's (5,)
      behavioral signature and fold the campaign into a
      :class:`~.frontier.CoverageMap` (``result["coverage"]``);
    - ``adapt``: coverage-steered sampling (implies ``signatures``;
      forces sequential batches, so incompatible with ``pipeline``):
      each batch oversamples ``adapt_oversample``-fold candidate
      cells and keeps the ones whose fault-axis cell has the highest
      behaviors-per-sample novelty — budget flows toward the axis
      cells still producing unseen behaviors.  ``coverage`` seeds
      the map (cross-campaign steering).

    The batches and repros run on ``device`` (CUDA unless given), or on
    ``mesh`` (module docstring)."""
    from ..tpu_sim.engine import check_mesh

    check_mesh(mesh)
    if workload not in ("broadcast", "counter", "kafka", "txn"):
        raise ValueError(f"unknown fuzz workload {workload!r}")
    if workload == "txn" and (signatures or adapt):
        raise ValueError(
            "the txn workload records per-transaction stamps, not "
            "telemetry rings — signatures/adapt are not wired for it")
    if adapt and pipeline:
        raise ValueError(
            "adapt needs the coverage of batch i before sampling "
            "batch i+1 — incompatible with pipelined dispatch")
    signatures = signatures or adapt
    kw = dict(runner_kw or {})
    if workload == "broadcast":
        kw.setdefault("n_values", 2 * n_nodes)
        kw.setdefault("topology", "grid")
        kw.setdefault("sync_every", 4)
        from ..parallel.topology import (grid, to_padded_neighbors,
                                         tree)
        nbrs_shape = to_padded_neighbors(
            {"grid": grid, "tree": tree}[kw["topology"]](
                n_nodes)).shape
    else:
        nbrs_shape = None

    n_batches = (n_scenarios + batch_size - 1) // batch_size
    counts = [min(batch_size, n_scenarios - b * batch_size)
              for b in range(n_batches)]
    delays_flags = [
        (workload == "broadcast"
         and {"alternate": b % 2 == 1,
              "on": True, "off": False}[delay_axis])
        for b in range(n_batches)]

    def _plant(cells, delays_on):
        cells[0] = planted_failure(workload, n_nodes, horizon)
        if delays_on:
            ones = tuple(tuple(1 for _ in range(nbrs_shape[1]))
                         for _ in range(nbrs_shape[0]))
            cells[0] = SC.Scenario(
                spec=cells[0].spec, parts=cells[0].parts,
                delays=ones,
                workload_seed=cells[0].workload_seed)
        return cells

    def _mk_batch(cells):
        return SC.ScenarioBatch(
            workload=workload, scenarios=tuple(cells),
            runner_kw=kw, max_recovery_rounds=max_recovery_rounds)

    t_sample = time.perf_counter()
    batches: list = [None] * n_batches
    if not adapt:
        for b in range(n_batches):
            cells = sample_scenarios(
                workload, counts[b], n_nodes=n_nodes,
                seed=seed * 1000 + b, horizon=horizon,
                nbrs_shape=nbrs_shape, delay_axis=delays_flags[b],
                membership_axis=membership_axis)
            if plant_failure and b == 0:
                cells = _plant(cells, delays_flags[b])
            batches[b] = _mk_batch(cells)
    sample_s = time.perf_counter() - t_sample

    # shape-bucket knobs: pow-2 crash-window counts, pow-2 scenario
    # counts (ragged tails padded up), and one campaign-wide trip-count
    # floor — every batch then has one shape per delay-axis setting
    kw_rounds = int(kw.get("rounds") or 0)
    n_windows = pad_to = None
    min_rounds = 0
    if shape_buckets:
        n_windows = _pow2(max(1, max(CRASH_GRID)))
        pad_to = _pow2(batch_size)
        shift = n_nodes + 2 if workload == "counter" else 0
        min_rounds = (max(horizon + shift, kw_rounds)
                      + max_recovery_rounds)

    if signatures:
        from .frontier import CoverageMap
        coverage = coverage if coverage is not None else CoverageMap()

    def _tel_spec(batch):
        # the signature ring must cover the batch's whole horizon
        # (scenario.py _sig_setup rejects a wrapping ring); with
        # shape_buckets the min_rounds floor dominates, so every
        # batch shares one ring shape
        if not signatures:
            return None
        mx = max(max(sc.spec.clear_round, kw_rounds)
                 for sc in batch.scenarios)
        r_tot = max(mx + max_recovery_rounds, min_rounds)
        return TM.TelemetrySpec(workload, rounds=r_tot)

    def _shape_key(batch):
        # program-shape key: a batch with a new shape (scenario
        # count, delays on/off, padded window counts) compiles fresh
        # — the steady-state rate must exclude its compile
        s = len(batch.scenarios)
        if pad_to:
            s = -(-s // pad_to) * pad_to
        w = max(len(sc.spec.crash) for sc in batch.scenarios)
        if n_windows:
            w = max(w, n_windows)
        return (s,
                any(sc.delays is not None for sc in batch.scenarios),
                w,
                max((0 if sc.parts is None
                     else len(sc.parts["starts"]))
                    for sc in batch.scenarios))

    def _dispatch(batch):
        return SC.dispatch_scenario_batch(
            batch, mesh=mesh, telemetry_spec=_tel_spec(batch),
            signatures=signatures, n_windows=n_windows,
            min_rounds=min_rounds, pad_to=pad_to, device=device)

    def _absorb(b, res):
        batch = batches[b]
        sigs = res.get("signatures")
        for i, row in enumerate(res["scenarios"]):
            row = dict(row)
            row.pop("final", None)
            row["batch"] = b
            if sigs is not None:
                sig = [int(v) for v in sigs[i]]
                row["signature"] = sig
                coverage.add(sig,
                             axis=_axis_key(batch.scenarios[i]),
                             meta={"batch": b, "index": i})
            rows.append(row)
            if not row["ok"]:
                failing.append((b, i, batch.scenarios[i]))

    rows = []
    failing = []
    batch_walls = []
    batch_shapes = []
    t0 = time.perf_counter()
    if adapt:
        # coverage-steered sampling: oversample candidate cells,
        # keep the ones whose fault-axis cell still has the highest
        # behaviors-per-sample novelty — NECESSARILY sequential
        # (batch i's signatures steer batch i+1's sampling)
        for b in range(n_batches):
            tb = time.perf_counter()
            cands = sample_scenarios(
                workload, counts[b] * max(1, adapt_oversample),
                n_nodes=n_nodes, seed=seed * 1000 + b,
                horizon=horizon, nbrs_shape=nbrs_shape,
                delay_axis=delays_flags[b],
                membership_axis=membership_axis)
            axes = [_axis_key(sc) for sc in cands]
            # greedy: highest coverage novelty first, discounting
            # axis cells already taken THIS batch (ties break on
            # candidate order — fully deterministic)
            picked: list = []
            local: dict = {}
            remaining = list(range(len(cands)))
            while len(picked) < counts[b] and remaining:
                best = max(
                    remaining,
                    key=lambda j: (coverage.novelty(axes[j])
                                   / (1 + 2 * local.get(axes[j], 0)),
                                   -j))
                picked.append(best)
                remaining.remove(best)
                local[axes[best]] = local.get(axes[best], 0) + 1
            cells = [cands[j] for j in sorted(picked)]
            if plant_failure and b == 0:
                cells = _plant(cells, delays_flags[b])
            batches[b] = _mk_batch(cells)
            res = SC.collect_scenario_batch(_dispatch(batches[b]))
            batch_walls.append(round(time.perf_counter() - tb, 3))
            batch_shapes.append(_shape_key(batches[b]))
            _absorb(b, res)
    elif pipeline:
        # depth 2: batch b is dispatched before batch b-1 is collected;
        # the verdicts are the sync path's
        pending = None
        for b in range(n_batches):
            tb = time.perf_counter()
            h = _dispatch(batches[b])
            if pending is not None:
                _absorb(b - 1, SC.collect_scenario_batch(pending))
            pending = h
            batch_walls.append(round(time.perf_counter() - tb, 3))
            batch_shapes.append(_shape_key(batches[b]))
        tb = time.perf_counter()
        _absorb(n_batches - 1, SC.collect_scenario_batch(pending))
        batch_walls[-1] = round(
            batch_walls[-1] + time.perf_counter() - tb, 3)
    else:
        for b, batch in enumerate(batches):
            tb = time.perf_counter()
            res = SC.run_scenario_batch(
                batch, mesh=mesh, telemetry_spec=_tel_spec(batch),
                signatures=signatures, n_windows=n_windows,
                min_rounds=min_rounds, pad_to=pad_to, device=device)
            batch_walls.append(round(time.perf_counter() - tb, 3))
            batch_shapes.append(_shape_key(batch))
            _absorb(b, res)
    dispatch_s = time.perf_counter() - t0

    distinct = len({json.dumps(r["spec"], sort_keys=True)
                    + json.dumps(r.get("parts"), sort_keys=True)
                    + json.dumps(r.get("delays"), sort_keys=True)
                    for r in rows})
    shrinks = []
    if shrink and failing:
        tel_rounds = horizon + max_recovery_rounds
        todo = (failing if max_shrinks is None
                else failing[:max_shrinks])
        for b, i, sc in todo:
            shrinks.append(shrink_scenario(
                workload, sc, kw, max_recovery_rounds,
                observe_dir=observe_dir or "artifacts/fuzz",
                tel_rounds=tel_rounds, device=device, mesh=mesh))
    total_s = time.perf_counter() - t0
    n_ok = sum(1 for r in rows if r["ok"])
    # steady-state throughput over batches whose shape already ran (the
    # first batch of each distinct shape is excluded, as the reference
    # excludes its compile)
    reused = [i for i in range(len(batches))
              if batch_shapes[i] in batch_shapes[:i]]
    steady = (round(sum(len(batches[i].scenarios) for i in reused)
                    / max(1e-9, sum(batch_walls[i] for i in reused)),
                    2) if reused else None)
    return {
        "workload": workload,
        "n_scenarios": len(rows),
        "n_distinct": distinct,
        "n_certified_ok": n_ok,
        "n_failing": len(failing),
        "failing": [{"batch": b, "index": i,
                     "scenario": sc.to_meta()}
                    for b, i, sc in failing],
        "n_batches": len(batches),
        "batch_size": batch_size,
        "batch_walls_s": batch_walls,
        "sample_s": round(sample_s, 3),
        "dispatch_s": round(dispatch_s, 3),
        "total_s": round(total_s, 3),
        "scenarios_per_sec": round(len(rows) / max(1e-9,
                                                   dispatch_s), 2),
        "scenarios_per_sec_steady": steady,
        "shape_buckets": bool(shape_buckets),
        "shape_knobs": ({"n_windows": n_windows, "pad_to": pad_to,
                         "min_rounds": min_rounds}
                        if shape_buckets else None),
        "n_program_shapes": len(set(batch_shapes)),
        "pipelined": bool(pipeline),
        "adapt": bool(adapt),
        "n_distinct_signatures": (coverage.n_distinct
                                  if signatures else None),
        "coverage": coverage.to_meta() if signatures else None,
        "shrinks": shrinks,
        "rows": rows,
    }


# -- serving-cell shrinking: the fault shrinker + the traffic axis -------


def _traffic_moves(t):
    """Candidate reductions of one TrafficSpec, most-aggressive
    first: halve the offered rate, drop / narrow / soften burst
    windows — the load-side mirror of :func:`_shrink_moves`."""
    if t.rate > 0.02:
        yield ("halve rate",
               dataclasses.replace(t, rate=round(t.rate / 2, 6)))
    for i, (s, e, m) in enumerate(t.burst):
        yield (f"drop burst window {i}",
               dataclasses.replace(
                   t, burst=tuple(w for j, w in enumerate(t.burst)
                                  if j != i)))
        if e - s > 1:
            nb = list(t.burst)
            nb[i] = (s, s + max(1, (e - s) // 2), m)
            yield (f"halve burst window {i} width",
                   dataclasses.replace(t, burst=tuple(nb)))
        if m > 2.0:
            nb = list(t.burst)
            nb[i] = (s, e, m / 2)
            yield (f"halve burst window {i} mult",
                   dataclasses.replace(t, burst=tuple(nb)))


def _serving_moves(cell):
    """Candidate reductions of one failing frontier grid cell: the
    traffic moves plus the fault moves (the scenario
    shrinker's, applied to the cell's NemesisSpec)."""
    for desc, t in _traffic_moves(cell.traffic):
        yield desc, dataclasses.replace(cell, traffic=t)
    if cell.spec is not None:
        for desc, cand in _shrink_moves(SC.Scenario(spec=cell.spec)):
            yield desc, dataclasses.replace(cell, spec=cand.spec)


def _serving_weight(cell) -> int:
    """Shrink-progress metric for one grid cell: offered load +
    burst windows + the fault spec's scenario weight."""
    w = int(round(100 * cell.traffic.rate)) \
        + 3 * len(cell.traffic.burst)
    if cell.spec is not None:
        w += scenario_weight(SC.Scenario(spec=cell.spec))
    return w


def run_serving_cell(workload: str, cell, runner_kw: dict, *,
                     max_recovery_rounds: int = 96,
                     drain_every: int = 8, telemetry=None,
                     observe_dir: str | None = None,
                     device=None) -> dict:
    """One frontier grid cell through the SEQUENTIAL serving runner
    (harness.serving.run_serving — the batched dispatch is pinned
    bit-exact against it), with the cell's grid coordinates attached
    so check_slo verdicts name them — the serving shrinker's
    oracle."""
    from . import serving as SV

    sim_kw = dict(runner_kw)
    if workload == "broadcast":
        sim_kw["topology"] = cell.topology
    res = SV.run_serving(
        workload, cell.traffic, nemesis=cell.spec, sim_kw=sim_kw,
        max_recovery_rounds=max_recovery_rounds,
        drain_every=drain_every, telemetry=telemetry,
        observe_dir=observe_dir, device=device)
    res["coords"] = list(cell.coords)
    return res


def shrink_serving_cell(workload: str, cell, runner_kw: dict,
                        slo: dict, *,
                        max_recovery_rounds: int = 96,
                        drain_every: int = 8, observe_dir,
                        max_iters: int = 200, device=None) -> dict:
    """Greedy auto-shrink of one SLO-failing frontier grid cell —
    the scenario shrinker extended with the traffic axis: a
    reduction (halved rate, dropped/narrowed burst window, any fault
    move) is accepted iff the reduced cell still fails ``check_slo``
    with the IDENTICAL violation-class signature
    (frontier.slo_signature).  Writes the shrunk cell's replayable
    flight bundle and certifies the replay reproduces the same
    failure classes from its JSON alone."""
    from . import observe
    from .frontier import _cell_bundle, slo_signature

    def _probe(c):
        row = run_serving_cell(
            workload, c, runner_kw,
            max_recovery_rounds=max_recovery_rounds,
            drain_every=drain_every, device=device)
        from .checkers import check_slo
        _ok, det = check_slo(row, **slo)
        return slo_signature(row, slo), row, det

    sig0, row0, det0 = _probe(cell)
    if sig0 is None:
        raise ValueError(
            "shrink_serving_cell needs an SLO-FAILING cell (the "
            "frontier verdict said this one failed but the "
            "sequential rerun passed — a batch/sequential "
            "divergence, which the parity tests pin against)")
    cur, cur_row, cur_det = cell, row0, det0
    trail = []
    iters = 0
    progress = True
    while progress and iters < max_iters:
        progress = False
        for desc, cand in _serving_moves(cur):
            iters += 1
            if iters > max_iters:
                break
            sig, row, det = _probe(cand)
            if sig == sig0:
                cur, cur_row, cur_det = cand, row, det
                trail.append(desc)
                progress = True
                break
    bundle_path = _cell_bundle(
        observe_dir, workload, cur, cur_row,
        {"problems": cur_det["problems"], "slo": dict(slo)},
        dict(runner_kw), max_recovery_rounds, drain_every)
    replay = observe.replay_bundle(bundle_path, device=device)
    replay["coords"] = list(cur.coords)
    replay_ok = slo_signature(replay, slo) == sig0
    return {
        "workload": workload,
        "original": cell.to_meta(),
        "shrunk": cur.to_meta(),
        "weight_before": _serving_weight(cell),
        "weight_after": _serving_weight(cur),
        "signature": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in sig0.items()},
        "moves_accepted": trail,
        "n_candidate_runs": iters,
        "bundle": bundle_path,
        "replay_same_failure": bool(replay_ok),
    }
