"""Rank-side cases of the hierarchical-mesh tests: module-level functions
that a spawned rank of ``dcn_worker.spawn_world`` runs as ``fn(mesh,
...)``.  :func:`hosts_world` runs, on the 4-rank world:

- every sim that takes a mesh on the 2 x 2 ``("hosts", "nodes")`` mesh of
  ``pick_mesh_2d(hosts=2)``, synchronous and pipelined, and on the flat
  4-rank mesh (:func:`sims_digests`), with the collectives each run made
  by axis;
- the 3-host case on ranks 0-2 (``make_mesh((3, 1), ...)``: a hosts axis
  of three, the OR ladder's ring fallback) against the flat 3-rank mesh;
- the engine's collectives, member by member, on both meshes and both
  modes, and under ``stale:3`` round by round (the tests hold them to a
  numpy model of the outbox);
- the stale counter campaign (sync and ``stale:4``), its flight bundle
  and the bundle's replay on the hierarchical mesh;
- the worker's hosts task set; the batches and the runners.

Every input is made from a seed with numpy, identically on every rank;
each function returns this rank's results as host values.  No JAX here:
the ranks import this module."""

import numpy as np
import torch

from gossip_glomers_tpu_torch.parallel import mesh as pmesh
from gossip_glomers_tpu_torch.parallel.dcn_worker import state_digest
from gossip_glomers_tpu_torch.parallel.topology import (
    grid, to_padded_neighbors, tree)
from gossip_glomers_tpu_torch.tpu_sim import (broadcast, counter, echo,
                                              engine, faults, kafka,
                                              structured, txn, unique_ids)

#: the reference's certified staleness spec (tests/test_dcn_pr20.py)
STALE_SPEC = dict(n_nodes=16, seed=3, crash=((1, 4, (2, 11)),),
                  loss_rate=0.2, loss_until=5)
#: the collectives' operands: rows a shard, rounds of the stale model
COLL_ROWS, STALE_ROUNDS, STALE_K = 3, 7, 3
#: the worker's hosts task set
HOST_TASKS = ("batch", "certify", "takeover", "pipelined", "stale")
#: the runners' campaign (every runner on the same spec)
RUN_SPEC = dict(n_nodes=16, seed=5, crash=((2, 5, (3, 9)),),
                loss_rate=0.15, loss_until=6)


def operand(rank: int, t: int, shape=(COLL_ROWS, 4)) -> np.ndarray:
    """Rank ``rank``'s int32 operand of round ``t``."""
    return np.random.default_rng(1000 * t + rank).integers(
        0, 1 << 12, shape).astype(np.int32)


def bits_operand(rank: int, t: int, shape=(COLL_ROWS, 4)) -> np.ndarray:
    """Rank ``rank``'s sparse bit words of round ``t`` (for OR / AND)."""
    rng = np.random.default_rng(5000 * t + rank)
    return np.where(rng.random(shape) < 0.8, -1,
                    rng.integers(0, 1 << 30, shape)).astype(np.int32) \
        if t % 2 else rng.integers(0, 1 << 30, shape).astype(np.int32)


def _calls(mesh, before: dict) -> dict:
    return {f"{k}@{a}": v - before.get((k, a), 0)
            for (k, a), v in mesh.calls_by_axis.items()
            if v > before.get((k, a), 0)}


def _t(a, mesh):
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)


def coll_members(mesh, mode) -> dict:
    """Every member of ``collectives`` on this rank's operands, and the
    calls by axis it made."""
    r = engine.node_index(mesh)
    before = dict(mesh.calls_by_axis)
    c = engine.collectives(COLL_ROWS, mesh, dcn=engine.resolve_dcn_mode(
        mode))
    x, b = _t(operand(r, 0), mesh), _t(bits_operand(r, 1), mesh)
    f = _t(operand(r, 2).astype(np.float32) / 7, mesh)
    big = _t(operand(r, 3, (COLL_ROWS, 5)).astype(np.int64) << 28, mesh)
    out = {"row_ids": c.row_ids.cpu().numpy(),
           "axis_name": c.axis_name,
           "sum": c.reduce_sum(x).cpu().numpy(),
           "sum_i64": c.reduce_sum(big).cpu().numpy(),
           "sum_f32": c.reduce_sum(f).cpu().numpy(),
           "sum_bool": c.reduce_sum(x > 2000).cpu().numpy(),
           "max": c.reduce_max(x).cpu().numpy(),
           "min": c.reduce_min(x).cpu().numpy(),
           "or": c.reduce_or(b).cpu().numpy(),
           "and": c.reduce_and(b).cpu().numpy(),
           "excl": c.exclusive_sum(x).cpu().numpy(),
           "widen": c.widen(x).cpu().numpy(),
           "scalar": c.reduce_sum(x[0, 0]).cpu().numpy()}
    out["calls"] = _calls(mesh, before)
    return out


def stale_rounds(mesh) -> dict:
    """``reduce_sum`` / ``reduce_or`` / ``reduce_and`` under ``stale:3``
    for :data:`STALE_ROUNDS` rounds of :class:`.engine.DcnRound`, the
    carry threaded round to round: each round's outputs, and the calls
    by axis of a refresh round and of a lag round."""
    r = engine.node_index(mesh)
    carry, outs, calls = None, [], []
    for t in range(STALE_ROUNDS):
        ctx = engine.DcnRound(f"stale:{STALE_K}", age=t, carry=carry)
        c = engine.collectives(COLL_ROWS, mesh, dcn=ctx)
        before = dict(mesh.calls_by_axis)
        x, b = _t(operand(r, t), mesh), _t(bits_operand(r, t), mesh)
        outs.append({"sum": c.reduce_sum(x).cpu().numpy(),
                     "or": c.reduce_or(b).cpu().numpy(),
                     "and": c.reduce_and(b).cpu().numpy()})
        calls.append(_calls(mesh, before))
        carry = ctx.carry_out()
    refusals = {}
    c = engine.collectives(COLL_ROWS, mesh, dcn=engine.DcnRound(
        f"stale:{STALE_K}", age=0))
    for name in ("reduce_max", "reduce_min", "widen", "exclusive_sum"):
        try:
            getattr(c, name)(_t(operand(r, 0), mesh))
            refusals[name] = "ran"
        except ValueError as e:
            refusals[name] = str(e)
    try:
        c.reduce_sum(_t(operand(r, 0).astype(np.float32), mesh))
        refusals["float_sum"] = "ran"
    except ValueError as e:
        refusals["float_sum"] = str(e)
    return {"rounds": outs, "calls": calls, "refusals": refusals}


def sims_digests(mesh, dcn_mode, n: int = 16, nv: int = 16) -> dict:
    """The checksummed end states of every sim that takes a mesh on
    ``mesh`` under ``dcn_mode`` (the reference's ``_sims_digests``,
    widened): the broadcast gather path and the structured halo path
    (server ledger on), the counter (cas and allreduce, ``run`` and
    ``run_fused``, and under a crash and loss plan), Kafka (steps, and
    under a plan with the push resync), txn, ids and echo."""
    k = engine.node_shards(mesh)
    out = {}
    sim = broadcast.BroadcastSim(to_padded_neighbors(grid(n)),
                                 n_values=nv, mesh=mesh, dcn_mode=dcn_mode)
    state, rounds = sim.run(broadcast.make_inject(n, nv))
    out["broadcast"] = {"rounds": int(rounds), "msgs": int(state.msgs),
                        "srv": int(state.srv_msgs),
                        "state": state_digest(state, mesh, node_dim=0)}
    sim = broadcast.BroadcastSim(
        to_padded_neighbors(tree(n)), n_values=nv, sync_every=4,
        mesh=mesh, dcn_mode=dcn_mode,
        exchange=structured.make_exchange("tree", n),
        sharded_exchange=structured.make_sharded_exchange("tree", n, k),
        sharded_sync_diff=structured.make_sharded_sync_diff("tree", n, k))
    state, rounds = sim.run(broadcast.make_inject(n, nv))
    out["broadcast_halo"] = {"rounds": int(rounds),
                             "msgs": int(state.msgs),
                             "srv": int(state.srv_msgs),
                             "state": state_digest(state, mesh)}
    nc = 12 if k == 3 else 8
    deltas = np.arange(1, nc + 1, dtype=np.int32)
    plan = faults.NemesisSpec(n_nodes=nc, seed=9, crash=((2, 5, (1, 6)),),
                              loss_rate=0.2, loss_until=8).compile(
                                  device=str(mesh.device))
    for mode in ("cas", "allreduce"):
        for runner in ("run", "run_fused"):
            sim = counter.CounterSim(nc, mode=mode, seed=7, mesh=mesh,
                                     dcn_mode=dcn_mode)
            state = getattr(sim, runner)(sim.add(sim.init_state(), deltas),
                                         12)
            out[f"counter_{mode}_{runner}"] = {
                "msgs": int(state.msgs), "kv": int(state.kv),
                "state": state_digest(state, mesh, node_dim=0)}
        sim = counter.CounterSim(nc, mode=mode, seed=7, mesh=mesh,
                                 dcn_mode=dcn_mode, fault_plan=plan)
        state = sim.run(sim.add(sim.init_state(), deltas), 16)
        out[f"counter_{mode}_plan"] = {
            "msgs": int(state.msgs), "kv": int(state.kv),
            "state": state_digest(state, mesh, node_dim=0)}
    if k == 3:
        return out
    rng = np.random.default_rng(0)
    for name, kw in (("kafka", {}),
                     ("kafka_push", dict(fault_plan=plan,
                                         resync_mode="push"))):
        sim = kafka.KafkaSim(nc, 4, 32, mesh=mesh, dcn_mode=dcn_mode, **kw)
        state = sim.init_state()
        for _ in range(6):
            sk = rng.integers(-1, 4, size=(nc, sim.max_sends)).astype(
                np.int32)
            sv = rng.integers(0, 100, size=(nc, sim.max_sends)).astype(
                np.int32)
            state = sim.step(state, sk, sv)
        out[name] = {"msgs": int(state.msgs), "lin_kv": sim.lin_kv(state),
                     "state": state_digest(
                         state, mesh, node_dim=0,
                         replicated=("log_vals", "kv_val"))}
    tsim = txn.TxnSim(16, 8, mesh=mesh, dcn_mode=dcn_mode,
                      fault_plan=faults.NemesisSpec(
                          n_nodes=16, seed=7, crash=((2, 4, (5,)),),
                          loss_rate=0.1, loss_until=5).compile(
                              device=str(mesh.device)))
    st = tsim.run(tsim.init_state(), 10)
    out["txn"] = {"msgs": int(st.msgs), "t": int(st.t),
                  "history": txn.history_of(st, tsim.ops, mesh),
                  "final": txn.final_registers(st, tsim.layout, mesh)}
    ids = unique_ids.UniqueIdsSim(64, max_per_round=4, mesh=mesh)
    ist = ids.init_state()
    minted = []
    for _ in range(3):
        ist, got = ids.step(ist, rng.integers(0, 5, 64).astype(np.int32))
        minted.append(ids.format_ids(mesh.all_gather(got)))
    out["ids"] = minted
    ec = echo.EchoSim(8, mesh=mesh)
    payload = np.arange(32, dtype=np.int32).reshape(8, 4)
    est, replies = ec.step(ec.init_state(), payload, payload % 3 == 0)
    out["echo"] = {"replies": mesh.all_gather(replies).cpu().numpy(),
                   "msgs": int(est.msgs)}
    return out


def _strip(x):
    """A runner's result without its per-run walls, paths and profiles."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if not (any(w in k for w in ("wall", "seconds", "path",
                                             "bundle", "profile", "_ms",
                                             "per_sec"))
                        or k.endswith("_s"))}
    if isinstance(x, (list, tuple)):
        return [_strip(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def runner_cases(mesh, dcn_mode) -> dict:
    """The runners on ``mesh`` under ``dcn_mode``: the three nemesis
    runners (the broadcast one with telemetry and provenance), txn,
    open-loop serving with telemetry, and the scenario batch."""
    from gossip_glomers_tpu_torch.harness import nemesis, serving
    from gossip_glomers_tpu_torch.harness import txn as htxn
    from gossip_glomers_tpu_torch.tpu_sim import scenario, traffic

    spec = faults.NemesisSpec(**RUN_SPEC)
    kw = dict(mesh=mesh, dcn_mode=dcn_mode)
    out = {"broadcast": nemesis.run_broadcast_nemesis(
        spec, n_values=16, topology="grid", telemetry=True,
        provenance=True, **kw),
        "broadcast_structured": nemesis.run_broadcast_nemesis(
            spec, n_values=16, topology="tree", structured=True, **kw),
        "counter": nemesis.run_counter_nemesis(spec, mode="cas",
                                               provenance=True, **kw),
        "kafka": nemesis.run_kafka_nemesis(
            faults.NemesisSpec(n_nodes=8, seed=11, crash=((3, 7, (1, 4)),),
                               loss_rate=0.25, loss_until=10),
            resync_mode="push", provenance=True, **kw),
        "txn": htxn.run_txn_nemesis(
            faults.NemesisSpec(n_nodes=16, seed=3, crash=((3, 6, (9,)),),
                               loss_rate=0.1, loss_until=8),
            n_keys=8, until=10, max_recovery_rounds=64, mesh=mesh)}
    tspec = traffic.TrafficSpec(n_nodes=16, n_clients=16, ops_per_client=4,
                                until=8, rate=0.4, seed=108)
    out["serving"] = serving.run_serving(
        "counter", tspec, nemesis=spec, telemetry=True, mesh=mesh,
        sim_kw=dict(mode="allreduce", dcn_mode=dcn_mode))
    batch = scenario.ScenarioBatch(
        workload="counter", max_recovery_rounds=24,
        runner_kw={"mode": "cas", "poll_every": 2, "dcn_mode": dcn_mode},
        scenarios=tuple(scenario.Scenario(spec=faults.random_spec(
            16, seed=i, horizon=6, loss_rate=0.1)) for i in range(8)))
    out["batch"] = scenario.run_scenario_batch(batch, mesh=mesh)
    return {k: _strip(v) for k, v in out.items()}


def stale_campaign(mesh, bundle_dir: str) -> dict:
    """The stale counter campaign (tests/test_dcn_pr20.py:334-400): sync
    and ``stale:4`` to 32 recovery rounds; ``stale:4`` to one recovery
    round with a flight bundle (rank 0 writes it), its replay on
    ``mesh``, and the sync twin at that budget."""
    from gossip_glomers_tpu_torch.harness import nemesis, observe

    spec = faults.NemesisSpec(**STALE_SPEC)
    out = {}
    for label, mode in (("sync", "sync"), ("stale", "stale:4")):
        res = nemesis.run_counter_nemesis(
            spec, mode="allreduce", mesh=mesh, max_recovery_rounds=32,
            dcn_mode=mode)
        out[label] = _strip(res)
    bad = nemesis.run_counter_nemesis(
        spec, mode="allreduce", mesh=mesh, max_recovery_rounds=1,
        dcn_mode="stale:4", observe_dir=bundle_dir)
    out["bad"] = _strip(bad)
    path = mesh.broadcast_object(bad.get("flight_bundle"), axis=(
        mesh.axis_names))
    out["bundle"] = observe.load_bundle(path)["runner_kw"]
    rep = observe.replay_bundle(path, mesh=mesh)
    out["replay"] = {"ok": rep["ok"],
                     "converged_round": rep["converged_round"]}
    out["sync_1"] = _strip(nemesis.run_counter_nemesis(
        spec, mode="allreduce", mesh=mesh, max_recovery_rounds=1,
        dcn_mode="sync"))
    # a stale outbox model: the carried backlog right after a lag round
    sim = counter.CounterSim(16, mode="allreduce", mesh=mesh,
                             dcn_mode="stale:4", poll_every=2)
    st = sim.add(sim.init_state(), np.arange(1, 17, dtype=np.int32))
    st = sim.step(st)
    st = sim.add(st, np.full(16, 2, np.int32))
    st = sim.step(st)
    backlog = sim.dcn_backlog().reshape(1)
    out["outbox"] = {"kv_after_lag": int(st.kv),
                     "pending": int(mesh.all_reduce(
                         st.pending.sum(dtype=torch.int64).reshape(1),
                         "sum", mesh.axis_names)[0]),
                     "backlog": int(mesh.all_reduce(
                         backlog, "sum", mesh.axis_names)[0])}
    for _ in range(3):
        st = sim.step(st)
    out["outbox"]["kv_after_refresh"] = int(st.kv)
    return out


def refusal_cases(hosts, flat) -> dict:
    """The stale refusals (the reference's refusal matrix): each message,
    or ``"ran"``."""
    from gossip_glomers_tpu_torch.tpu_sim import scenario

    out = {}
    nbrs = to_padded_neighbors(grid(16))

    def probe(name, fn):
        try:
            fn()
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)

    probe("kafka", lambda: kafka.KafkaSim(8, 4, 32, mesh=hosts,
                                          dcn_mode="stale:2"))
    probe("txn", lambda: txn.TxnSim(8, 4, mesh=hosts, dcn_mode="stale:2"))
    probe("broadcast", lambda: broadcast.BroadcastSim(
        nbrs, n_values=16, mesh=hosts, dcn_mode="stale:2"))
    probe("counter_cas", lambda: counter.CounterSim(
        16, mode="cas", mesh=hosts, dcn_mode="stale:2"))
    probe("counter_device", lambda: counter.CounterSim(
        16, mode="allreduce", kv_backend="device", mesh=hosts,
        dcn_mode="stale:2"))
    probe("counter_flat", lambda: counter.CounterSim(
        16, mode="allreduce", mesh=flat, dcn_mode="stale:2"))
    probe("counter_stale", lambda: counter.CounterSim(
        16, mode="allreduce", mesh=hosts, dcn_mode="stale:2"))
    sim = counter.CounterSim(16, mode="allreduce", mesh=hosts,
                             dcn_mode="stale:2")
    probe("counter_observed", lambda: sim.run_observed(
        sim.init_state(), None, None, 1, prov=object(), prov_spec=None))
    probe("counter_traffic", lambda: sim.run_traffic(
        sim.init_state(), None, None, 1))
    probe("scenario", lambda: scenario._refuse_stale_dcn(
        "a scenario batch", {"dcn_mode": "stale:2"}))
    probe("bare_mode", lambda: engine.collectives(
        2, hosts, dcn=engine.DcnMode(stale_k=2)))
    probe("flat_mode", lambda: engine.collectives(
        2, flat, dcn=engine.DcnMode(stale_k=2)))
    probe("string_dcn", lambda: engine.collectives(2, hosts, dcn="stale:2"))
    probe("dcn_psum", lambda: engine.dcn_psum(hosts, "stale:2"))
    return out


def three_hosts(world) -> dict | None:
    """Ranks 0-2: a 3-host mesh (one rank a host) and the flat 3-rank
    mesh; every rank of the world makes both groups, rank 3 runs
    nothing."""
    import torch.distributed as dist

    hier3 = pmesh.make_mesh((3, 1), ("hosts", "nodes"), ranks=[0, 1, 2],
                            device=world.device)
    g3 = dist.new_group([0, 1, 2])
    if hier3 is None:
        return None
    flat3 = pmesh.Mesh(g3, device=world.device)
    out = {}
    for name, mesh, mode in (("h3_sync", hier3, "sync"),
                             ("h3_pipe", hier3, "pipelined"),
                             ("flat", flat3, "pipelined")):
        out[name] = {"sims": sims_digests(mesh, mode, n=12, nv=8),
                     "coll": coll_members(mesh, mode)}
    return out


def hosts_world(world, bundle_dir: str) -> dict:
    """The hierarchical rank body: the hosts mesh's shape; every sim and
    runner on it (sync and pipelined) and on the flat mesh; the
    collectives; the stale cases; the 3-host case; the worker's tasks."""
    from gossip_glomers_tpu_torch.parallel import dcn_worker

    flat = world
    hosts = pmesh.pick_mesh_2d(hosts=2, device=world.device)
    # the reference's contract: None on an uneven host split or a cap
    # below the host count; a cap shrinks the per-host axis first
    picks = {"uneven": pmesh.pick_mesh_2d(hosts=3, device=world.device),
             "cap_below": pmesh.pick_mesh_2d(hosts=2, max_axis=1,
                                             device=world.device),
             "cap_2": pmesh.pick_mesh_2d(hosts=2, max_axis=2,
                                         device=world.device)}
    out = {"shape": hosts.shape, "coords": hosts.coords,
           "node_axis": list(hosts.node_axis),
           "node_index": engine.node_index(hosts),
           "node_shards": engine.node_shards(hosts),
           "node_axes": engine.node_axes(hosts),
           "picks": {k: None if m is None else m.shape
                     for k, m in picks.items()}}
    for name, mesh, mode in (("flat", flat, "sync"),
                             ("hosts_sync", hosts, "sync"),
                             ("hosts_pipe", hosts, "pipelined")):
        before = dict(mesh.calls_by_axis)
        sims = sims_digests(mesh, mode)
        out[name] = {"sims": sims, "calls": _calls(mesh, before),
                     "coll": coll_members(mesh, mode),
                     "runners": runner_cases(mesh, mode)}
    out["stale_coll"] = stale_rounds(hosts)
    out["stale"] = stale_campaign(hosts, bundle_dir)
    out["refusals"] = refusal_cases(hosts, flat)
    out["three"] = three_hosts(world)
    out["tasks"] = {"hosts": dcn_worker.run_tasks(HOST_TASKS, hosts,
                                                  timed=False),
                    "flat": dcn_worker.run_tasks(HOST_TASKS[:4], flat,
                                                 timed=False)}
    return out
