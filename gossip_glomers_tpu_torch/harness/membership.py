"""Certified elastic-resize campaigns on PyTorch: the port of
gossip_glomers_tpu/harness/membership.py.  A workload runs at capacity N,
is checkpointed mid-flight (the fault spec rides the meta,
:mod:`..tpu_sim.checkpoint`), restored into a larger or smaller padded
node axis (:mod:`..tpu_sim.membership`), continued to convergence, and
certified with :func:`.checkers.check_recovery`: no lost acknowledged
write across the boundary, a bounded recovery after it.

The straight-through twin anchors the certificate: the boundary as an
ordinary membership event at a fixed capacity (a grow runs the
continuation spec at N' from round 0, a shrink the original spec at N).
For capacity-independent dynamics the restored run and its twin are
bit-exact on the first min(N, N') rows at the final round:

- broadcast on the ``full`` topology only (every edge coin hashes the
  global ``(t, src, dst)`` ids, and only ``full`` keeps the edge set
  between surviving rows when N changes);
- the counter (all coupling goes through the shared KV cell);
- Kafka is certified only: its op staging draws ``rng.random(n)`` a
  round, so the host stream depends on the capacity; the continuation
  stages fresh ops under ``workload_seed + 1`` with values offset by
  1,000,000.

``kv_keys`` also emits the moved-key diff of the KV routing and checks it
against the device mask and an :func:`..tpu_sim.membership.apply_rehoming`
carry.  The sims are built on ``device`` (CUDA unless given) and their
states stay there between checks; the convergence check reads the device
once a round.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..parallel.topology import full, to_padded_neighbors
from ..tpu_sim import checkpoint, kvstore
from ..tpu_sim import membership as M
from ..tpu_sim.broadcast import BroadcastSim, BroadcastState, make_inject
from ..tpu_sim.counter import CounterSim, CounterState
from ..tpu_sim.engine import resolve_device
from ..tpu_sim.faults import NemesisSpec
from ..tpu_sim.kafka import KafkaSim, KafkaState
from .checkers import check_recovery
from .nemesis import kafka_lost_writes, stage_kafka_ops


def _certify(*, clear: int, converged_round, max_recovery_rounds: int,
             lost, msgs_at_clear: int, msgs_at_converged: int) -> tuple:
    return check_recovery(
        clear_round=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost_writes=lost,
        msgs_at_clear=msgs_at_clear,
        msgs_at_converged=msgs_at_converged)


def _rehoming_details(n_keys: int, n_from: int, n_to: int,
                      device: torch.device) -> dict:
    """Emit and check the resize's moved-key diff: the host routing twin
    against the device mask, then an apply_rehoming carry on the device
    (every key's (value, version) register survives at its new home)."""
    moved_host = M.rehomed_keys(n_keys, n_from, n_to)
    moved_dev = torch.nonzero(M.rehomed_mask(
        n_keys, n_from, n_to, device=device))[:, 0].cpu().numpy()
    diff_match = bool(np.array_equal(moved_host, moved_dev))
    lo = kvstore.make_layout(n_keys, n_from)
    ln = kvstore.make_layout(n_keys, n_to)
    keys = torch.arange(n_keys, dtype=torch.int32, device=device)
    rows = kvstore.init_rows(lo, device)

    def at(layout):
        return tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                     for a in (layout.owner, layout.slot))

    rows.vals[at(lo)] = keys * 3 + 1
    rows.vers[at(lo)] = keys % 7
    rows2 = M.apply_rehoming(rows, lo, ln)
    carry_ok = bool(torch.equal(rows2.vals[at(ln)], keys * 3 + 1)
                    and torch.equal(rows2.vers[at(ln)], keys % 7))
    return {"n_keys": n_keys, "n_moved": int(moved_host.size),
            "moved_keys": [int(k) for k in moved_host],
            "diff_match": diff_match, "carry_ok": carry_ok,
            "ok": diff_match and carry_ok}


def run_resize_campaign(workload: str, spec: NemesisSpec, n_to: int,
                        resize_round: int, *,
                        checkpoint_dir: str | None = None,
                        n_values: int | None = None,
                        sync_every: int = 4,
                        topology: str = "full",
                        deltas: np.ndarray | None = None,
                        mode: str = "cas", poll_every: int = 2,
                        n_keys: int = 4, capacity: int = 64,
                        max_sends: int = 2, resync_every: int = 4,
                        workload_seed: int = 0, send_prob: float = 0.7,
                        max_recovery_rounds: int = 96,
                        twin: bool = True,
                        kv_keys: int | None = None,
                        device: str | torch.device | None = None) -> dict:
    """One certified elastic resize on ``device`` (CUDA unless given):
    ``spec`` at ``spec.n_nodes`` through round ``resize_round``,
    checkpoint, restore at ``n_to`` (grow or shrink; the shrink's safety
    is checked first), run to convergence, certify no lost acknowledged
    write, and for broadcast and the counter hold the restored run
    bit-exact against its straight-through twin (``twin=False`` skips
    it).  ``kv_keys`` adds the KV re-homing diff.  Returns the details
    dict, ``ok`` the AND of every verdict."""
    runners = {"broadcast": _resize_broadcast,
               "counter": _resize_counter,
               "kafka": _resize_kafka}
    if workload not in runners:
        raise ValueError(
            f"resize campaigns support {sorted(runners)}; {workload!r} "
            "is not wired: the txn workload's wound-or-die CAS rows "
            "re-home on resize (the device KV registers move nodes) "
            "and its runner has no membership-aware liveness gate yet "
            "— run txn churn at fixed capacity")
    # checked before any device work
    spec2 = M.resize_spec(spec, n_to, resize_round)
    clear = max(spec2.clear_round, spec.clear_round, resize_round)
    dev = resolve_device(device)
    tmp = None
    if checkpoint_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="gg_resize_")
        checkpoint_dir = tmp.name
    try:
        path = os.path.join(
            checkpoint_dir,
            f"resize_{workload}_{spec.n_nodes}to{n_to}.npz")
        kw = dict(n_values=n_values, sync_every=sync_every,
                  topology=topology, deltas=deltas, mode=mode,
                  poll_every=poll_every, n_keys=n_keys,
                  capacity=capacity, max_sends=max_sends,
                  resync_every=resync_every,
                  workload_seed=workload_seed, send_prob=send_prob)
        ok, details = runners[workload](
            spec, n_to, resize_round, clear, path, dev,
            max_recovery_rounds=max_recovery_rounds, twin=twin, **kw)
    finally:
        if tmp is not None:
            tmp.cleanup()
    if kv_keys is not None:
        rh = _rehoming_details(kv_keys, spec.n_nodes, n_to, dev)
        details["rehoming"] = rh
        ok = ok and rh["ok"]
    details.update(workload=workload, n_from=spec.n_nodes, n_to=n_to,
                   resize_round=resize_round, spec=spec.to_meta(),
                   continuation_spec=spec2.to_meta())
    return {"ok": ok, **details}


def _recover(step, conv, state, clear: int, max_recovery_rounds: int):
    """(state, converged round or None): rounds past ``clear`` until
    ``conv`` holds (one device read a round)."""
    converged_round = clear if conv(state) else None
    while converged_round is None \
            and state.t < clear + max_recovery_rounds:
        state = step(state)
        if conv(state):
            converged_round = state.t
    return state, converged_round


def _outside(members: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(~members).to(dev)


def _twin_record(m: int, t_total: int, grow: bool, match: bool) -> dict:
    return {"rows_compared": m, "round": t_total,
            "shape": "grow" if grow else "shrink", "bit_exact": match}


def _resize_broadcast(spec, n_to, resize_round, clear, path, dev, *,
                      max_recovery_rounds, twin, n_values, sync_every,
                      topology, **_unused):
    if topology != "full":
        raise ValueError(
            f"broadcast resize campaigns run on topology 'full' only, "
            f"got {topology!r}: every full-topology edge coin hashes "
            "the global (t, src, dst) ids, so the edge set between "
            "surviving rows is capacity-independent — a grid/tree "
            "re-wires its rows when N changes and the straight-"
            "through twin would diverge for topology reasons")
    n = spec.n_nodes
    nv = n_values if n_values is not None else 2 * n
    # acknowledged where injected: founding members, original capacity
    inject = make_inject(n, nv)
    inject = np.where(spec.host_members(0)[:, None], inject,
                      0).astype(inject.dtype)

    def sim_at(n_rows, sp):
        return BroadcastSim(to_padded_neighbors(full(n_rows)), n_values=nv,
                            sync_every=sync_every,
                            fault_plan=sp.compile(device=dev),
                            srv_ledger=False, device=dev)

    sim_a = sim_at(n, spec)
    state, target = sim_a.stage(inject)
    state = sim_a.run_staged_fixed(state, resize_round)
    checkpoint.save(path, state, meta={"workload": "broadcast",
                                       "n_values": nv},
                    fault_spec=spec)
    state, spec2, _meta = M.restore_resized(path, BroadcastState, n_to,
                                            device=dev)
    sim_b = sim_at(n_to, spec2)
    if clear > resize_round:
        state = sim_b.run_staged_fixed(state, clear - resize_round)
    msgs_at_clear = int(state.msgs)
    members_c = spec2.host_members(clear)
    outside = _outside(members_c, dev)[:, None]

    def conv(s) -> bool:
        return bool(((s.received == target[None, :]) | outside).all())

    state, converged_round = _recover(sim_b.step, conv, state, clear,
                                      max_recovery_rounds)
    rec = sim_b.received_node_major(state)
    tgt = target.cpu().numpy().view(np.uint32)
    anywhere = np.bitwise_or.reduce(
        np.where(members_c[:, None], rec, 0), axis=0)
    lost = [v for v in range(nv)
            if ((tgt[v // 32] >> (v % 32)) & 1)
            and not (anywhere[v // 32] >> (v % 32)) & 1]
    ok, details = _certify(
        clear=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost=lost,
        msgs_at_clear=msgs_at_clear,
        msgs_at_converged=int(state.msgs))
    details.update(n_values=nv, topology=topology)
    if twin:
        t_total, grow = state.t, n_to > n
        inj_tw = inject
        if grow:
            inj_tw = np.concatenate(
                [inject, np.zeros((n_to - n,) + inject.shape[1:],
                                  inject.dtype)], axis=0)
        sim_tw = sim_at(n_to, spec2) if grow else sim_at(n, spec)
        st_tw, _ = sim_tw.stage(inj_tw)
        st_tw = sim_tw.run_staged_fixed(st_tw, t_total)
        m = n_to  # grow: the whole resized axis; shrink: surviving rows
        match = (torch.equal(state.received[:m], st_tw.received[:m])
                 and torch.equal(state.frontier[:m], st_tw.frontier[:m]))
        details["twin"] = _twin_record(m, t_total, grow, match)
        ok = ok and match
    return ok, details


def _resize_counter(spec, n_to, resize_round, clear, path, dev, *,
                    max_recovery_rounds, twin, deltas, mode,
                    poll_every, **_unused):
    n = spec.n_nodes
    if deltas is None:
        deltas = np.arange(1, n + 1, dtype=np.int32)
    # acknowledged where staged: founding members at the original
    # capacity; the acknowledged sum is a constant across the boundary
    deltas = np.where(spec.host_members(0), deltas,
                      0).astype(np.asarray(deltas).dtype)
    acked_sum = int(np.sum(deltas))

    def sim_at(n_rows, sp):
        return CounterSim(n_rows, mode=mode, poll_every=poll_every,
                          fault_plan=sp.compile(device=dev), device=dev)

    sim_a = sim_at(n, spec)
    state = sim_a.run_fused(sim_a.add(sim_a.init_state(), deltas),
                            resize_round)
    checkpoint.save(path, state, meta={"workload": "counter"},
                    fault_spec=spec)
    state, spec2, _meta = M.restore_resized(path, CounterState, n_to,
                                            device=dev)
    sim_b = sim_at(n_to, spec2)
    if clear > resize_round:
        state = sim_b.run_fused(state, clear - resize_round)
    msgs_at_clear = int(state.msgs)
    outside = _outside(spec2.host_members(clear), dev)

    def conv(s) -> bool:
        # a non-member's residue is a real undrained delta
        return bool((s.pending.sum(dtype=torch.int64) == 0)
                    & ((s.cached == s.kv) | outside).all())

    state, converged_round = _recover(sim_b.step, conv, state, clear,
                                      max_recovery_rounds)
    kv = sim_b.kv_value(state)
    shortfall = acked_sum - kv - int(state.pending.sum(dtype=torch.int64))
    lost = [{"lost_sum": shortfall}] if shortfall != 0 else []
    ok, details = _certify(
        clear=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost=lost,
        msgs_at_clear=msgs_at_clear,
        msgs_at_converged=int(state.msgs))
    details.update(mode=mode, acked_sum=acked_sum, kv=kv)
    if twin:
        t_total, grow = state.t, n_to > n
        d_tw = deltas
        if grow:
            d_tw = np.concatenate(
                [deltas, np.zeros(n_to - n, deltas.dtype)])
        sim_tw = sim_at(n_to, spec2) if grow else sim_at(n, spec)
        st_tw = sim_tw.run_fused(sim_tw.add(sim_tw.init_state(), d_tw),
                                 t_total)
        m = n_to
        match = (torch.equal(state.pending[:m], st_tw.pending[:m])
                 and torch.equal(state.cached[:m], st_tw.cached[:m])
                 and kv == sim_tw.kv_value(st_tw))
        details["twin"] = _twin_record(m, t_total, grow, match)
        ok = ok and match
    return ok, details


def _resize_kafka(spec, n_to, resize_round, clear, path, dev, *,
                  max_recovery_rounds, twin, n_keys, capacity,
                  max_sends, resync_every, workload_seed, send_prob,
                  **_unused):
    n = spec.n_nodes
    quiesce_a = (resync_every + 2) if spec.has_membership else 0
    sks, svs, crs = stage_kafka_ops(
        spec, resize_round, n_keys=n_keys, max_sends=max_sends,
        workload_seed=workload_seed, send_prob=send_prob,
        quiesce=quiesce_a)

    def sim_at(n_rows, sp):
        return KafkaSim(n_rows, n_keys, capacity=capacity,
                        max_sends=max_sends,
                        fault_plan=sp.compile(device=dev),
                        resync_every=resync_every, device=dev)

    sim_a = sim_at(n, spec)
    state = sim_a.run_fused(sim_a.init_state(), sks, svs, crs)
    n_alloc_a = int((state.log_vals >= 0).sum())
    checkpoint.save(path, state, meta={"workload": "kafka",
                                       "n_keys": n_keys},
                    fault_spec=spec)
    state, spec2, _meta = M.restore_resized(path, KafkaState, n_to,
                                            device=dev)
    sim_b = sim_at(n_to, spec2)
    # continuation ops: a fresh stream (workload_seed + 1), staged over
    # absolute rounds with spec2's liveness and cut to the continuation;
    # values offset so that acknowledged slots stay unique across it
    quiesce_b = resync_every + 2  # spec2 always has membership
    sks2, svs2, crs2 = stage_kafka_ops(
        spec2, clear, n_keys=n_keys, max_sends=max_sends,
        workload_seed=workload_seed + 1, send_prob=send_prob,
        quiesce=quiesce_b)
    sks2 = sks2[resize_round:]
    svs2 = np.where(sks2 >= 0, svs2[resize_round:] + 1_000_000,
                    svs2[resize_round:])
    crs2 = crs2[resize_round:]
    if sks2.shape[0] > 0:
        state = sim_b.run_fused(state, sks2, svs2, crs2)
    msgs_at_clear = int(state.msgs)
    members_c = spec2.host_members(clear)
    ref = int(np.argmax(members_c))
    outside = _outside(members_c, dev)[:, None, None]

    def conv(s) -> bool:
        pres = s.present
        return bool(((pres == pres[ref:ref + 1]) | outside).all())

    state, converged_round = _recover(sim_b.step, conv, state, clear,
                                      max_recovery_rounds)
    lost = kafka_lost_writes(sim_b, state, members_c)
    ok, details = _certify(
        clear=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost=lost,
        msgs_at_clear=msgs_at_clear,
        msgs_at_converged=int(state.msgs))
    details.update(n_keys=n_keys,
                   n_allocated=int((state.log_vals >= 0).sum()),
                   n_allocated_pre_resize=n_alloc_a,
                   twin={"bit_exact": None,
                         "reason": "kafka is certified-only: op "
                                   "staging draws rng.random(n) per "
                                   "round, so the host rng stream "
                                   "depends on the padded capacity"})
    return ok, details
