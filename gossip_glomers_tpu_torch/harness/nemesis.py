"""Nemesis campaigns on PyTorch: the port of
gossip_glomers_tpu/harness/nemesis.py — drive each stateful sim under a
seeded crash / loss / dup :class:`..tpu_sim.faults.NemesisSpec`
(optionally with a partition schedule) and certify recovery, the
counterpart of a Maelstrom run with the kill and lossy-network nemeses
followed by its post-heal checks.

Each ``run_*_nemesis`` function:

1. compiles the spec to a :class:`..tpu_sim.faults.FaultPlan` on
   ``device`` (CUDA unless given) and builds the sim with it;
2. runs the faulted phase to ``spec.clear_round`` (the fixed-trip
   drivers, or the observed ones when telemetry or provenance is on);
3. steps the recovery phase round by round until the workload's
   convergence predicate holds (broadcast: every node holds every value;
   counter: pending drained and every cache equals the KV; Kafka: every
   node's presence identical), at most ``max_recovery_rounds``; the
   predicates run on the device and read back one bool a round;
4. certifies with :func:`.checkers.check_recovery` (bounded recovery,
   no lost acknowledged write), and with telemetry on
   :func:`.checkers.check_telemetry`, with provenance on
   :func:`.checkers.check_provenance` (every recorded first delivery
   held to the fault model itself).

The result is the reference's dict, field for field
(tests/test_torch_nemesis_runner.py).  ``traffic=`` hands the campaign
to :func:`.serving.run_serving`.  ``observe_dir``: where a failed
campaign writes its flight bundle (:func:`.observe.write_flight_bundle`,
the reference's ``runner_kw``, so that either package replays it).

``mesh=`` (a :class:`..parallel.mesh.Mesh`, every rank calling) runs a
campaign on the mesh's sims: the traffic, telemetry and provenance
drivers on the mesh, the fixed-trip and stepped rounds of the sims' mesh
paths, the convergence predicates agreed over the ranks (one all-reduce
a round), the lost-write reads collective, the provenance record
gathered once and certified on the host by rank 0, which shares its
verdict, a failed campaign's bundle written by rank 0, and every rank
returning the whole result.  ``dcn_mode=`` (the hosts level's
schedule on a hierarchical mesh, :func:`..tpu_sim.engine.resolve_dcn_mode`)
goes to the sims and, when given, into ``runner_kw``, so that a flight
bundle replays the mode; a counter campaign under ``stale:k`` converges
only once its staleness outbox has delivered every delta
(:meth:`..tpu_sim.counter.CounterSim.dcn_backlog`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.topology import grid, to_padded_neighbors, tree
from ..tpu_sim import provenance as PV
from ..tpu_sim import structured as S
from ..tpu_sim import telemetry as TM
from ..tpu_sim.broadcast import BroadcastSim, Partitions, make_inject
from ..tpu_sim.counter import CounterSim
from ..tpu_sim.engine import (check_mesh, host_unpack_bits, node_index,
                               node_shards, resolve_device)
from ..tpu_sim.faults import NemesisSpec
from ..tpu_sim.kafka import KafkaSim
from ..tpu_sim.kernels import or_rows, unpack_bits
from . import observe
from .checkers import check_provenance, check_recovery, check_telemetry

_TOPOLOGIES = {"grid": grid, "tree": tree}
# structured="auto" on the CPU takes the gather path from this many words
# a node (the reference's NEM_GATHER_MIN_W default); on the card the
# structured path
_NEM_GATHER_MIN_W = 8


def _place(mesh, device, dcn_mode=None) -> tuple:
    """(device, the sims' placement keywords): the mesh's, or
    ``device``'s; with ``dcn_mode`` when one is given."""
    check_mesh(mesh)
    extra = {} if dcn_mode is None else dict(dcn_mode=dcn_mode)
    if mesh is not None:
        return mesh.device, dict(mesh=mesh, **extra)
    dev = resolve_device(device)
    return dev, dict(device=dev, **extra)


def _with_mode(kw: dict, dcn_mode) -> dict:
    """``kw`` with ``dcn_mode`` recorded when it is set (older bundles
    stay as they were, and a replay reruns the campaign in the mode)."""
    return kw if dcn_mode is None else dict(kw, dcn_mode=dcn_mode)


def _block(sim, x: np.ndarray) -> np.ndarray:
    """This rank's block of a per-node host array (all of it off a
    mesh)."""
    if sim.mesh is None:
        return x
    b = sim.n_nodes // node_shards(sim.mesh)
    return x[node_index(sim.mesh) * b:(node_index(sim.mesh) + 1) * b]


def _agree(sim, flag) -> bool:
    """A convergence flag (a rank's, on a mesh) agreed over the mesh."""
    ok = bool(flag)
    return ok if sim.mesh is None else sim.mesh.agree(ok)


def _neighbors(topology: str, n: int) -> np.ndarray:
    try:
        build = _TOPOLOGIES[topology]
    except KeyError:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"one of {sorted(_TOPOLOGIES)}") from None
    return to_padded_neighbors(build(n))


def _failure_of(details: dict) -> dict:
    keys = ("clear_round", "converged_round", "recovery_rounds",
            "n_lost_writes", "lost_writes")
    return {k: details[k] for k in keys if k in details}


def _unpack_obs(out, tel, prov):
    """Unpack an observed driver's ``(state, tel?, prov?)`` carry in
    order (``run_observed`` returns exactly the leaves passed)."""
    if tel is None and prov is None:
        return out, None, None
    out = list(out)
    state = out.pop(0)
    new_tel = out.pop(0) if tel is not None else None
    new_prov = out.pop(0) if prov is not None else None
    return state, new_tel, new_prov


def _finish_provenance(ok: bool, details: dict, prov, prov_spec,
                       spec: NemesisSpec, *, workload: str,
                       check_kw: dict, mesh=None) -> bool:
    """Certify the recorded stamps against the fault model itself
    (:func:`.checkers.check_provenance`), put the arrays and the verdict
    (and the broadcast dissemination tree) in ``details['provenance']``
    and AND the verdict in.  On a ``mesh`` the node-split records
    (broadcast, counter) are gathered once; rank 0 certifies them on the
    host and shares its verdict, so every rank returns the same
    details (collective calls)."""
    if prov is None:
        return ok
    if mesh is not None and workload != "kafka":
        prov = type(prov)(*(mesh.all_gather(x) for x in prov))
    arrs = PV.arrays_of(prov)

    def certify():
        ok_p, p_det = check_provenance(workload, arrs, spec=spec,
                                       **check_kw)
        tree = (observe.dissemination_tree(arrs)
                if workload == "broadcast" else None)
        return ok_p, p_det, tree

    if mesh is None:
        ok_p, p_det, tree = certify()
    else:
        ok_p, p_det, tree = mesh.broadcast_object(
            certify() if mesh.rank == 0 else None)
    entry = {"spec": prov_spec.to_meta(), "check": p_det, "arrays": arrs}
    if tree is not None:
        entry["tree"] = tree
    details["provenance"] = entry
    return ok and ok_p


def _finish_observed(ok: bool, details: dict, tel, tel_spec, *,
                     msgs_total: int, observe_dir, workload: str,
                     spec: NemesisSpec, runner_kw: dict,
                     mesh=None) -> bool:
    """Put the recorded telemetry series in ``details['telemetry']``,
    cross-checked against the run's ledger
    (:func:`.checkers.check_telemetry`: a broken recorder fails the
    run); on a failure write the flight bundle into ``observe_dir``, with
    the recorded series and provenance stamps, so that the replay can
    report its first-divergence round."""
    series = tel_meta = None
    if tel is not None:
        series = TM.series_arrays(tel, tel_spec)
        ok_t, t_det = check_telemetry(series, msgs_total=msgs_total)
        details["telemetry"] = {"spec": tel_spec.to_meta(),
                                "series": series, "check": t_det}
        tel_meta = tel_spec.to_meta()
        ok = ok and ok_t
    if not ok and observe_dir is not None:
        prov_entry = details.get("provenance") or {}
        prov_arrays = prov_entry.get("arrays")
        details["flight_bundle"] = observe.write_bundle_on_mesh(
            mesh, observe_dir, kind="nemesis", workload=workload,
            nemesis=spec.to_meta(), runner_kw=runner_kw,
            telemetry_spec=tel_meta, telemetry_series=series,
            provenance_spec=prov_entry.get("spec"),
            provenance=(None if prov_arrays is None
                        else {k: np.asarray(v).tolist()
                              for k, v in prov_arrays.items()}),
            failure=_failure_of(details))
    return ok


def _no_traffic_provenance(provenance):
    """Open-loop runs record through the traffic drivers, which carry no
    stamps: an explicit request fails loudly (the env switch stays inert
    there)."""
    if provenance not in (None, False):
        raise ValueError(
            "provenance rides the quiescent nemesis runners; the "
            "open-loop traffic drivers do not carry the stamp record "
            "(drop traffic= or provenance=)")


def run_broadcast_nemesis(spec: NemesisSpec, *, n_values: int | None = None,
                          topology: str = "grid", sync_every: int = 4,
                          parts: Partitions | None = None, delays=None,
                          dir_delays=None, max_recovery_rounds: int = 96,
                          mesh=None, structured: "bool | str" = False,
                          traffic=None, telemetry=None, provenance=None,
                          observe_dir=None, dcn_mode: str | None = None,
                          device: str | torch.device | None = None) -> dict:
    """Broadcast under the full nemesis (crash / loss / dup from
    ``spec``, plus an optional partition schedule ``parts``, a
    :class:`..tpu_sim.broadcast.Partitions` or its meta dict): values
    injected round-robin at round 0, convergence = every member node
    holds every value; a lost acknowledged write is a value absent from
    every member node.  ``structured``: the words-major path (the same
    plan as per-direction masks, ``structured.make_nemesis``, with
    ``dir_delays``) instead of the gather path (per-edge ``delays``);
    ``"auto"`` picks by device and width.  ``traffic``: the open-loop
    campaign (:func:`.serving.run_serving`).  ``telemetry`` /
    ``provenance`` (None: the ``GG_TELEMETRY`` / ``GG_PROVENANCE``
    switch; True / False; a spec): run on the observed driver, record
    the ring and / or the arrival and parent stamps (gather path only),
    certify them, and put them in the result.  ``observe_dir``: where a
    failed campaign writes its flight bundle.  ``mesh``: run on the mesh
    (module docstring)."""
    dev, place = _place(mesh, device, dcn_mode)
    n = spec.n_nodes
    nv = n_values if n_values is not None else 2 * n
    if isinstance(parts, dict):
        parts = Partitions.from_meta(parts)
    if delays is not None:
        delays = np.asarray(delays, np.int32)
        if structured is True:
            raise ValueError(
                "per-edge delays ride the gather path; drop "
                "structured= for a delayed campaign")
        structured = False          # "auto" resolves to gather too
    if traffic is not None:
        from . import serving
        _no_traffic_provenance(provenance)
        if parts is not None:
            raise ValueError(
                "traffic= composes with the FaultPlan nemesis; "
                "partition schedules are not wired into the serving "
                "runners yet")
        if structured == "auto":
            structured = _auto_structured(
                (traffic.n_clients * traffic.ops_per_client + 31) // 32, dev)
        sim_kw = _with_mode(dict(topology=topology, sync_every=sync_every,
                                 structured=bool(structured)), dcn_mode)
        if delays is not None:
            sim_kw["delays"] = delays.tolist()
        if dir_delays is not None:
            sim_kw.update(structured=True, dir_delays=tuple(dir_delays))
        if n_values is not None:
            sim_kw["n_values"] = nv
        return serving.run_serving(
            "broadcast", traffic, nemesis=spec,
            max_recovery_rounds=max_recovery_rounds, sim_kw=sim_kw,
            telemetry=telemetry, observe_dir=observe_dir, mesh=mesh,
            device=dev)
    if structured == "auto":
        # membership events ride the gather path (the words-major masks
        # have no join / leave columns)
        structured = (False if spec.has_membership
                      else _auto_structured((nv + 31) // 32, dev))
    kw = {}
    if structured:
        groups = (parts.group.cpu().numpy() if parts is not None else None)
        kw = dict(exchange=S.make_exchange(topology, n),
                  nemesis=S.make_nemesis(
                      topology, n, spec, groups=groups, device=dev,
                      n_shards=None if mesh is None else node_shards(mesh),
                      dir_delays=(None if dir_delays is None
                                  else tuple(dir_delays))))
    elif dir_delays is not None:
        raise ValueError(
            "dir_delays is the words-major delay-ring mode: pass "
            "structured=True (per-edge gather delays ride delays=)")
    nbrs = _neighbors(topology, n)
    sim = BroadcastSim(nbrs, n_values=nv, sync_every=sync_every,
                       parts=parts, delays=delays,
                       fault_plan=spec.compile(device=dev),
                       srv_ledger=False, **place, **kw)
    inject = make_inject(n, nv)
    if spec.has_membership:
        # a value is acked where it is injected: pre-join rows stage
        # nothing, so their round-robin values are never offered
        inject = np.where(spec.host_members(0)[:, None], inject,
                          0).astype(inject.dtype)
    target = sim.target_bits(inject)
    clear = spec.clear_round
    members_c = spec.host_members(clear)
    tel_spec = observe.telemetry_setup(telemetry, "broadcast",
                                       clear + max_recovery_rounds)
    tel = sim.telemetry_state(tel_spec) if tel_spec is not None else None
    prov_spec = observe.provenance_setup(provenance, "broadcast")
    if prov_spec is not None and structured:
        raise ValueError(
            "broadcast provenance rides the gather path; drop "
            "structured= for a provenance-on campaign")
    prov = (sim.provenance_state(prov_spec, inject)
            if prov_spec is not None else None)
    obs_on = tel is not None or prov is not None
    state = sim.init_state(inject)
    if clear > 0:
        if not obs_on:
            state = sim.run_staged_fixed(state, clear, donate=True)
        else:
            state, tel, prov = _unpack_obs(
                sim.run_observed(state, tel, tel_spec, clear, donate=True,
                                 prov=prov, prov_spec=prov_spec), tel, prov)
    msgs_at_clear = int(state.msgs)
    if spec.has_membership:
        # only member rows must (or can) hold the target
        lay = (lambda x: x[:, None]) if sim.words_major else \
            (lambda x: x[None, :])
        tgt = lay(target)
        outside = torch.from_numpy(_block(sim, ~members_c).copy()).to(dev)
        outside = outside[None, :] if sim.words_major else outside[:, None]

        def conv_b(s) -> bool:
            return _agree(sim, ((s.received == tgt) | outside).all())
    else:
        def conv_b(s) -> bool:
            return sim.converged(s, target)

    converged_round = clear if conv_b(state) else None
    while converged_round is None \
            and state.t < clear + max_recovery_rounds:
        if not obs_on:
            state = sim.step(state)
        else:
            state, tel, prov = _unpack_obs(
                sim.run_observed(state, tel, tel_spec, 1, donate=True,
                                 prov=prov, prov_spec=prov_spec), tel, prov)
        if conv_b(state):
            converged_round = state.t
    rec = sim.received_node_major(state)
    anywhere = np.bitwise_or.reduce(
        np.where(members_c[:, None], rec, 0), axis=0)
    target_np = target.cpu().numpy().view(np.uint32)
    lost = [v for v in range(nv)
            if ((target_np[v // 32] >> (v % 32)) & 1)
            and not (anywhere[v // 32] >> (v % 32)) & 1]
    ok, details = check_recovery(
        clear_round=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost_writes=lost,
        msgs_at_clear=msgs_at_clear, msgs_at_converged=int(state.msgs))
    details.update(workload="broadcast", n_nodes=n, n_values=nv,
                   topology=topology, msgs_total=int(state.msgs),
                   path="structured" if structured else "gather",
                   spec=spec.to_meta())
    ok = _finish_provenance(
        ok, details, prov, prov_spec, spec, workload="broadcast",
        check_kw=dict(nbrs=nbrs, received=host_unpack_bits(rec, nv),
                      msgs_total=int(state.msgs),
                      parts=None if parts is None else parts.to_meta()),
        mesh=mesh)
    runner_kw = dict(n_values=n_values, topology=topology,
                     sync_every=sync_every, structured=bool(structured),
                     max_recovery_rounds=max_recovery_rounds,
                     parts=None if parts is None else parts.to_meta(),
                     delays=None if delays is None else delays.tolist(),
                     dir_delays=(None if dir_delays is None
                                 else list(dir_delays)))
    runner_kw = _with_mode(runner_kw, dcn_mode)
    ok = _finish_observed(ok, details, tel, tel_spec,
                          msgs_total=int(state.msgs),
                          observe_dir=observe_dir, workload="broadcast",
                          spec=spec, runner_kw=runner_kw, mesh=mesh)
    return {"ok": ok, **details}


def _auto_structured(n_words: int, device: torch.device) -> bool:
    """``structured="auto"``: the gather path on the CPU from
    :data:`_NEM_GATHER_MIN_W` words a node, else the structured one."""
    return not (device.type == "cpu" and n_words >= _NEM_GATHER_MIN_W)


def run_counter_nemesis(spec: NemesisSpec, *,
                        deltas: np.ndarray | None = None,
                        mode: str = "cas", poll_every: int = 2,
                        max_recovery_rounds: int = 64,
                        union_block: "int | str | None" = None,
                        mesh=None, traffic=None, telemetry=None,
                        provenance=None, observe_dir=None,
                        dcn_mode: str | None = None,
                        device: str | torch.device | None = None) -> dict:
    """G-counter under the nemesis: per-node ``deltas`` acked at round 0
    (default 1 .. N), convergence = pending drained and every member
    node's cached read equal to the KV; lost acknowledged writes = the
    shortfall ``acked_sum - kv - pending``, the deltas that died in
    amnesia rows before they flushed.  ``traffic``: the open-loop
    campaign (``deltas`` ignored).  ``provenance``: the per-node flush,
    KV and visibility stamps (see :func:`run_broadcast_nemesis`).
    ``mesh``: run on the mesh (module docstring)."""
    dev, place = _place(mesh, device, dcn_mode)
    if traffic is not None:
        from . import serving
        _no_traffic_provenance(provenance)
        return serving.run_serving(
            "counter", traffic, nemesis=spec,
            max_recovery_rounds=max_recovery_rounds,
            sim_kw=_with_mode(dict(mode=mode, poll_every=poll_every,
                                   union_block=union_block), dcn_mode),
            telemetry=telemetry, observe_dir=observe_dir, mesh=mesh,
            device=dev)
    n = spec.n_nodes
    if deltas is None:
        deltas = np.arange(1, n + 1, dtype=np.int32)
    if spec.has_membership:
        # deltas are acked where they are staged: pre-join rows stage
        # nothing
        deltas = np.where(spec.host_members(0), deltas,
                          0).astype(np.asarray(deltas).dtype)
    acked_sum = int(np.sum(deltas))
    sim = CounterSim(n, mode=mode, poll_every=poll_every,
                     fault_plan=spec.compile(device=dev),
                     union_block=union_block, **place)
    state = sim.add(sim.init_state(), deltas)
    clear = spec.clear_round
    members_c = spec.host_members(clear)
    tel_spec = observe.telemetry_setup(telemetry, "counter",
                                       clear + max_recovery_rounds)
    tel = sim.telemetry_state(tel_spec) if tel_spec is not None else None
    prov_spec = observe.provenance_setup(provenance, "counter")
    prov = sim.provenance_state(prov_spec) if prov_spec is not None else None
    obs_on = tel is not None or prov is not None
    if clear > 0:
        if not obs_on:
            state = sim.run_fused(state, clear)
        else:
            state, tel, prov = _unpack_obs(
                sim.run_observed(state, tel, tel_spec, clear, donate=True,
                                 prov=prov, prov_spec=prov_spec), tel, prov)
    msgs_at_clear = int(state.msgs)
    # only member rows must re-poll to the KV value; pending stays summed
    # over all rows (a non-member's residue is a real undrained delta)
    outside = torch.from_numpy(_block(sim, ~members_c).copy()).to(dev)

    def pending_sum(s) -> torch.Tensor:
        # the undelivered deltas: pending, and under a stale mode the
        # staleness outbox's (in flight, not lost)
        p = s.pending.sum(dtype=torch.int64) + sim.dcn_backlog()
        return p if mesh is None else mesh.all_reduce(p, "sum",
                                                      mesh.axis_names)

    def converged(s) -> bool:
        stale = (~((s.cached == s.kv) | outside)).sum(dtype=torch.int64)
        if mesh is not None:
            # one all-reduce: the undelivered total and the stale caches
            p, stale = mesh.all_reduce(torch.stack([
                s.pending.sum(dtype=torch.int64) + sim.dcn_backlog(),
                stale]), "sum", mesh.axis_names)
            return bool((p == 0) & (stale == 0))
        return bool((s.pending.sum() == 0) & (stale == 0))

    converged_round = clear if converged(state) else None
    while converged_round is None \
            and state.t < clear + max_recovery_rounds:
        if not obs_on:
            state = sim.step(state)
        else:
            state, tel, prov = _unpack_obs(
                sim.run_observed(state, tel, tel_spec, 1, donate=True,
                                 prov=prov, prov_spec=prov_spec), tel, prov)
        if converged(state):
            converged_round = state.t
    kv = sim.kv_value(state)
    shortfall = acked_sum - kv - (int(pending_sum(state)) if mesh is not None
                                  else int(state.pending.sum(
                                      dtype=torch.int32)))
    lost = [{"lost_sum": shortfall}] if shortfall != 0 else []
    ok, details = check_recovery(
        clear_round=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost_writes=lost,
        msgs_at_clear=msgs_at_clear, msgs_at_converged=int(state.msgs))
    details.update(workload="counter", n_nodes=n, mode=mode,
                   acked_sum=acked_sum, kv=kv, msgs_total=int(state.msgs),
                   spec=spec.to_meta())
    ok = _finish_provenance(ok, details, prov, prov_spec, spec,
                            workload="counter",
                            check_kw=dict(final_kv=kv), mesh=mesh)
    deltas_kw = (None if np.array_equal(
        deltas, np.arange(1, n + 1, dtype=np.int32))
        else [int(d) for d in np.asarray(deltas)])
    runner_kw = _with_mode(dict(
        deltas=deltas_kw, mode=mode, poll_every=poll_every,
        max_recovery_rounds=max_recovery_rounds, union_block=union_block),
        dcn_mode)
    ok = _finish_observed(ok, details, tel, tel_spec,
                          msgs_total=int(state.msgs),
                          observe_dir=observe_dir, workload="counter",
                          spec=spec, runner_kw=runner_kw, mesh=mesh)
    return {"ok": ok, **details}


def stage_kafka_ops(spec: NemesisSpec, rounds: int, *, n_keys: int,
                    max_sends: int, send_prob: float = 0.7,
                    commit_prob: float = 0.2, workload_seed: int = 0,
                    commits: bool = True, quiesce: int = 0,
                    ) -> "tuple[np.ndarray, np.ndarray, np.ndarray | None]":
    """Seeded (R, N, S) send batches and (R, N, K) commit requests for a
    campaign (the reference's, rng call for rng call): ops are staged
    only at nodes up that round, values are globally unique.
    ``commits=False`` returns ``crs=None`` and stages the sends
    vectorized.  ``quiesce``: a leaving node stops taking sends that many
    rounds before its leave round."""
    rng = np.random.default_rng(workload_seed)
    n, s = spec.n_nodes, max_sends
    lr = spec._membership_rows()[1].astype(np.int64)
    sks = np.full((rounds, n, s), -1, np.int32)
    svs = np.zeros((rounds, n, s), np.int32)
    if not commits:
        vid = 0
        for t in range(rounds):
            up = spec.host_up(t) & (t < lr - quiesce)
            send = (rng.random(n) < send_prob) & up
            k = rng.integers(0, n_keys, n).astype(np.int32)
            sks[t, :, 0] = np.where(send, k, -1)
            cnt = int(send.sum())
            svs[t, send, 0] = np.arange(vid, vid + cnt, dtype=np.int32)
            vid += cnt
        return sks, svs, None
    crs = np.full((rounds, n, n_keys), -1, np.int32)
    vid = 0
    for t in range(rounds):
        up = spec.host_up(t) & (t < lr - quiesce)
        for i in range(n):
            if not up[i]:
                continue
            if rng.random() < send_prob:
                sks[t, i, 0] = rng.integers(0, n_keys)
                svs[t, i, 0] = vid
                vid += 1
            if rng.random() < commit_prob:
                crs[t, i, rng.integers(0, n_keys)] = rng.integers(1, 6)
    return sks, svs, crs


def kafka_campaign(sim: KafkaSim, spec: NemesisSpec, staged: tuple,
                   clear: int, *, max_recovery_rounds: int = 48,
                   tel=None, tel_spec=None, prov=None, prov_spec=None):
    """The Kafka campaign's rounds on a built ``sim``: the ``staged``
    ``(sks, svs, crs)`` batches (numpy or device tensors; ``crs`` None
    for a send-only campaign) through the faulted phase, then quiescent
    rounds until every member node's presence equals the first member's,
    at most ``max_recovery_rounds`` past ``clear``.  Returns ``(state,
    tel, prov, msgs_at_clear, converged_round or None)``."""
    n, s_dim = sim.n_nodes, sim.max_sends
    sks, svs, crs = staged
    members_c = spec.host_members(clear)
    obs_on = tel is not None or prov is not None
    state = sim.init_state()
    if clear > 0:
        if not obs_on:
            state = sim.run_fused(state, sks, svs, crs)
        else:
            state, tel, prov = _unpack_obs(
                sim.run_observed(state, tel, tel_spec, sks, svs, crs,
                                 donate=True, prov=prov,
                                 prov_spec=prov_spec), tel, prov)
    msgs_at_clear = int(state.msgs)
    ref = int(np.argmax(members_c)) if spec.has_membership else 0
    outside = torch.from_numpy(_block(sim, ~members_c).copy()).to(
        sim.device)[:, None, None]

    def converged(st) -> bool:
        pres = st.present
        if sim.mesh is None:
            row = pres[ref:ref + 1]
        else:
            # the reference row from the rank that holds it (one sum)
            loc = ref - sim._row0
            row = sim._coll.reduce_sum(
                pres[loc:loc + 1] if 0 <= loc < sim._block
                else torch.zeros_like(pres[:1]))
        if not spec.has_membership:
            return _agree(sim, (pres == row).all())
        # member rows against the first member (row 0 may have left)
        return _agree(sim, ((pres == row) | outside).all())

    # a quiescent round: an empty one-round send batch, commit-free
    quiet = np.full((1, n, s_dim), -1, np.int32)
    converged_round = clear if converged(state) else None
    while converged_round is None \
            and state.t < clear + max_recovery_rounds:
        if obs_on:
            state, tel, prov = _unpack_obs(
                sim.run_observed(state, tel, tel_spec, quiet,
                                 np.zeros_like(quiet), donate=True,
                                 prov=prov, prov_spec=prov_spec), tel, prov)
        elif crs is not None:
            state = sim.step(state)
        else:
            # send-only campaigns skip the (N, K) all -1 commit batch
            state = sim.run_fused(state, quiet, np.zeros_like(quiet))
        if converged(state):
            converged_round = state.t
    return state, tel, prov, msgs_at_clear, converged_round


def kafka_lost_writes(sim: KafkaSim, state, members: np.ndarray) -> list:
    """The campaign's lost acknowledged writes: allocated (key, offset)
    slots present at no member node (offset = slot + 1), then every
    committed-offset cache above its shared cell, read on the device."""
    present, lc = state.present, state.local_committed
    if sim.mesh is not None:
        # a host read: the whole presence and caches, gathered
        present, lc = sim._coll.widen(present), sim._coll.widen(lc)
    pres_any = or_rows(present[torch.from_numpy(members).to(sim.device)])
    held = unpack_bits(pres_any, sim.capacity)
    missing = (state.log_vals >= 0) & ~held
    lost = [(int(k), int(c) + 1)
            for k, c in torch.nonzero(missing).cpu().tolist()]
    kv = state.kv_val
    over = lc > torch.where(kv > 0, kv, 0)[None, :]
    lost += [{"committed_over_cell": (int(i), int(k))}
             for i, k in torch.nonzero(over).cpu().tolist()]
    return lost


def run_kafka_nemesis(spec: NemesisSpec, *, n_keys: int = 4,
                      capacity: int = 64, max_sends: int = 2,
                      resync_every: int = 4, resync_mode: str = "pull",
                      workload_seed: int = 0,
                      max_recovery_rounds: int = 48,
                      rounds: int | None = None,
                      repl_fast: bool | None = None,
                      union_block: "int | str | None" = None,
                      commits: bool = True, send_prob: float = 0.7,
                      mesh=None, traffic=None, telemetry=None,
                      provenance=None, observe_dir=None,
                      dcn_mode: str | None = None,
                      device: str | torch.device | None = None) -> dict:
    """Replicated log under the nemesis: seeded send / commit traffic at
    live nodes through the faulted phase (:func:`stage_kafka_ops`, for
    ``rounds`` rounds or to ``spec.clear_round``), then quiescent
    recovery until every node's presence is identical
    (:func:`kafka_campaign`).  Lost acknowledged writes: allocated slots
    present at no member node, and committed caches above their cell
    (:func:`kafka_lost_writes`).  ``resync_mode``, ``repl_fast``,
    ``union_block``, ``commits`` and ``send_prob`` as in the reference;
    ``traffic``: the open-loop campaign.  ``provenance``: the per-(key,
    slot) allocation, origin and witness-presence stamps (the witness
    from the ``ProvenanceSpec``).  ``mesh``: run on the mesh (module
    docstring)."""
    dev, place = _place(mesh, device, dcn_mode)
    if traffic is not None:
        from . import serving
        _no_traffic_provenance(provenance)
        return serving.run_serving(
            "kafka", traffic, nemesis=spec,
            max_recovery_rounds=max_recovery_rounds,
            sim_kw=_with_mode(dict(
                n_keys=n_keys, capacity=capacity, max_sends=max_sends,
                resync_every=resync_every, resync_mode=resync_mode,
                union_block=union_block), dcn_mode),
            telemetry=telemetry, observe_dir=observe_dir, mesh=mesh,
            device=dev)
    n = spec.n_nodes
    clear = max(spec.clear_round, rounds or 0)
    members_c = spec.host_members(clear)
    # leaving nodes drain for a resync period before they go
    quiesce = (resync_every + 2) if spec.has_membership else 0
    staged = stage_kafka_ops(
        spec, clear, n_keys=n_keys, max_sends=max_sends,
        workload_seed=workload_seed, commits=commits, send_prob=send_prob,
        quiesce=quiesce)
    sim = KafkaSim(n, n_keys, capacity=capacity, max_sends=max_sends,
                   fault_plan=spec.compile(device=dev),
                   resync_every=resync_every, resync_mode=resync_mode,
                   repl_fast=repl_fast, union_block=union_block, **place)
    tel_spec = observe.telemetry_setup(telemetry, "kafka",
                                       clear + max_recovery_rounds)
    tel = sim.telemetry_state(tel_spec) if tel_spec is not None else None
    prov_spec = observe.provenance_setup(provenance, "kafka")
    prov = sim.provenance_state(prov_spec) if prov_spec is not None else None
    state, tel, prov, msgs_at_clear, converged_round = kafka_campaign(
        sim, spec, staged, clear, max_recovery_rounds=max_recovery_rounds,
        tel=tel, tel_spec=tel_spec, prov=prov, prov_spec=prov_spec)
    lost = kafka_lost_writes(sim, state, members_c)
    ok, details = check_recovery(
        clear_round=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost_writes=lost,
        msgs_at_clear=msgs_at_clear, msgs_at_converged=int(state.msgs))
    details.update(workload="kafka", n_nodes=n, n_keys=n_keys,
                   n_allocated=int((state.log_vals >= 0).sum()),
                   msgs_total=int(state.msgs), spec=spec.to_meta())
    ok = _finish_provenance(
        ok, details, prov, prov_spec, spec, workload="kafka",
        check_kw=dict(n_nodes=n, resync_every=resync_every,
                      resync_mode=resync_mode,
                      witness=(prov_spec.witness
                               if prov_spec is not None else 0)),
        mesh=mesh)
    runner_kw = dict(n_keys=n_keys, capacity=capacity, max_sends=max_sends,
                     resync_every=resync_every, resync_mode=resync_mode,
                     workload_seed=workload_seed,
                     max_recovery_rounds=max_recovery_rounds, rounds=rounds,
                     repl_fast=repl_fast, union_block=union_block,
                     commits=commits, send_prob=send_prob)
    runner_kw = _with_mode(runner_kw, dcn_mode)
    ok = _finish_observed(ok, details, tel, tel_spec,
                          msgs_total=int(state.msgs),
                          observe_dir=observe_dir, workload="kafka",
                          spec=spec, runner_kw=runner_kw, mesh=mesh)
    return {"ok": ok, **details}
