"""Rank-side cases of the mesh tests: module-level functions that a
spawned rank of ``dcn_worker.spawn_world`` runs as ``fn(mesh, ...)``.
Every input is made from a seed with numpy, identically on every rank;
each function returns this rank's results as numpy (the tests stitch the
ranks' blocks in rank order and hold them against the JAX package on its
virtual-device mesh).  No JAX here: the ranks import this module."""

import numpy as np
import torch

from gossip_glomers_tpu_torch.parallel.topology import (
    circulant, expander_strides, grid, line, random_regular, ring,
    to_padded_neighbors, tree)
from gossip_glomers_tpu_torch.tpu_sim import broadcast, engine, kernels
from gossip_glomers_tpu_torch.tpu_sim import structured, timing

ROLL_SHIFTS = (0, 1, -1, "B-1", "-(B-1)", "B", "B+3", "-(B+3)", "2B+1")
SHIFT_SHIFTS = (0, 1, -1, "B-1", "-(B-1)")
HALO_CASES = [("ring", 64, {}),
              ("circulant", 64, {"strides": expander_strides(64, 6, 1)}),
              ("circulant", 128, {"strides": [1, 5, 33]}),
              ("tree", 64, {}),
              ("tree", 256, {"branching": 2}),
              ("grid", 256, {}),
              ("line", 64, {})]
COLL_ROWS = 2          # rows a shard of the collectives' operands


def shift_value(spec, block: int) -> int:
    if isinstance(spec, int):
        return spec
    return int(eval(spec.replace("B", str(block))))


def words(shape, seed: int) -> np.ndarray:
    """Random uint32 words."""
    return np.random.default_rng(seed).integers(
        0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def live_rows(d: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((d, n)) < 0.6


def halo_groups(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, (1, n)).astype(np.int8)


def _t(a: np.ndarray, mesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else
                            np.ascontiguousarray(a)).to(mesh.device)


def _np(x: torch.Tensor) -> np.ndarray:
    a = x.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _cols(mesh, a: np.ndarray) -> np.ndarray:
    b = a.shape[-1] // mesh.size
    return a[..., mesh.rank * b:(mesh.rank + 1) * b]


# -- the collectives, the halo primitives, the exchanges -------------------


def collective_cases(mesh, seed: int) -> dict:
    p, k = mesh.rank, mesh.size
    n = k * COLL_ROWS
    x = words((n, 3), seed)
    y = np.random.default_rng(seed + 1).integers(
        -1 << 40, 1 << 40, (n, 2)).astype(np.int64)
    m = np.random.default_rng(seed + 2).integers(0, 100, (n, n))
    rows = slice(p * COLL_ROWS, (p + 1) * COLL_ROWS)
    xl, yl = _t(x[rows], mesh), _t(y[rows], mesh)
    coll = engine.collectives(COLL_ROWS, mesh, gather_axis=0)
    out = {"row_ids": _np(coll.row_ids)}
    before = dict(mesh.calls)
    out["reduce_or"] = _np(coll.reduce_or(xl))
    out["reduce_and"] = _np(coll.reduce_and(xl))
    out["exclusive_sum"] = _np(coll.exclusive_sum(yl))
    y32 = _t((y[rows] >> 30).astype(np.int32), mesh)
    out["exclusive_sum32"] = _np(coll.exclusive_sum(y32))
    out["ladder_calls"] = {kind: mesh.calls[kind] - before.get(kind, 0)
                           for kind in ("ppermute", "all_gather",
                                        "all_reduce")}
    for name in ("reduce_sum", "reduce_max", "reduce_min"):
        out[name] = _np(getattr(coll, name)(yl))
        out[name + "32"] = _np(getattr(coll, name)(y32))
    out["widen"] = _np(coll.widen(xl))
    out["local_cols"] = _np(coll.local_cols(_t(m, mesh)))
    out["axis_name"] = coll.axis_name
    return out


def halo_primitive_cases(mesh, seed: int, block: int, w: int) -> dict:
    n = block * mesh.size
    x = words((w, n), seed)
    xl = _t(_cols(mesh, x), mesh)
    out = {}
    for spec in ROLL_SHIFTS:
        s = shift_value(spec, block)
        out[("roll", spec)] = _np(engine.sharded_roll(xl, s, n, mesh.size,
                                                      mesh))
    for spec in SHIFT_SHIFTS:
        s = shift_value(spec, block)
        out[("shift", spec)] = _np(engine.sharded_shift(xl, s, mesh.size,
                                                        mesh))
    return out


def exchange_cases(mesh, seed: int, cases=HALO_CASES, w: int = 2) -> dict:
    """Per case: the halo exchange of a random block, its sync diff's
    partial, the masked halo exchange and masked sync diff's partial of
    random live rows (``make_faulted(n_shards=)``), and the collective
    calls the unmasked exchange made."""
    out = {}
    for i, (topo, n, kw) in enumerate(cases):
        p = words((w, n), seed + i)
        pl = _t(_cols(mesh, p), mesh)
        ex = structured.make_sharded_exchange(topo, n, mesh.size, mesh,
                                              **kw)
        before = dict(mesh.calls)
        res = {"exchange": _np(ex(pl))}
        res["calls"] = {kind: mesh.calls[kind] - before.get(kind, 0)
                        for kind in ("ppermute", "all_gather",
                                     "all_reduce")}
        res["sync_diff"] = int(structured.make_sharded_sync_diff(
            topo, n, mesh.size, mesh, **kw)(pl))
        f = structured.make_faulted(topo, n, halo_groups(n, seed + i),
                                    n_shards=mesh.size, **kw)
        live = live_rows(f.exists.shape[0], n, seed + 100 + i)
        lv = kernels.pack_bits(torch.from_numpy(
            np.ascontiguousarray(_cols(mesh, live)))).to(mesh.device)
        res["masked"] = _np(f.sharded_exchange.bind(mesh)(pl, lv))
        res["masked_sync_diff"] = int(f.sharded_sync_diff.bind(mesh)(pl, lv))
        out[(topo, n)] = res
    return out


def tree_halo_parts(mesh, seed: int, n: int, k: int, w: int) -> dict:
    """The tree's halves on their own: tree_parent_payload and
    tree_kids_payload of a random block."""
    p = words((w, n), seed)
    pl = _t(_cols(mesh, p), mesh)
    return {"parent": _np(structured.tree_parent_payload(
                pl, n, mesh.size, k, mesh)),
            "kids": _np(structured.tree_kids_payload(
                pl, n, mesh.size, k, mesh)),
            "exchange": _np(structured.tree_sharded_exchange(
                pl, n, mesh.size, k, mesh))}


#: the mesh combinations that run: since the traffic, telemetry and txn
#: slice, and the provenance and scenario-batch slice, and since the
#: two-axis slice ``dcn_mode`` in every sim, the engine's collectives
#: with a mode, and ``inject_mid`` on a mesh (every probe of
#: :func:`refusal_cases`)
MESH_RUNS = ("run_traffic", "run_observed", "counter_run_traffic",
             "counter_run_observed", "kafka_run_traffic",
             "kafka_run_observed", "txn", "run_observed_prov",
             "counter_run_observed_prov", "kafka_run_observed_prov",
             "kafka_batch_round", "scenario_batch", "dcn_mode",
             "inject_mid", "collectives_dcn", "counter_dcn_mode",
             "kafka_dcn_mode")


def refusal_cases(mesh) -> dict:
    """Which mesh combinations raise NotImplementedError (naming their
    ROADMAP.md item), and which run (:data:`MESH_RUNS`: ``"ran"``)."""
    n = 4 * mesh.size
    nbrs = to_padded_neighbors(tree(n))
    ex = structured.make_exchange("tree", n)
    out = {}

    def probe(name, fn):
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)

    from gossip_glomers_tpu_torch.tpu_sim import faults

    spec = faults.NemesisSpec(n_nodes=n, seed=1, crash=((1, 3, (1,)),))
    plan = spec.compile(device=str(mesh.device))
    kw = dict(n_values=4, mesh=mesh)
    probe("dcn_mode", lambda: broadcast.BroadcastSim(
        nbrs, dcn_mode="sync", **kw))
    from gossip_glomers_tpu_torch.tpu_sim import (provenance, telemetry,
                                                  traffic)

    # one client a rank, one op each: the traffic and observed drivers
    # run, the observed driver's provenance record too
    tspec = traffic.TrafficSpec(n_nodes=n, n_clients=mesh.size,
                                ops_per_client=1, until=2)
    inj = np.zeros((n, 1), np.uint32)

    def tel(sim_, workload, traffic_=False):
        spec = telemetry.TelemetrySpec(workload, rounds=2, traffic=traffic_)
        return sim_.telemetry_state(spec), spec

    def traffic_tel(sim_, workload):
        ring, spec = tel(sim_, workload, True)
        return dict(tel=ring, tel_spec=spec)

    sim = broadcast.BroadcastSim(nbrs, srv_ledger=False, **kw)
    probe("run_traffic", lambda: sim.run_traffic(
        sim.init_state(inj), sim.traffic_state(tspec), tspec, 1,
        **traffic_tel(sim, "broadcast")))
    probe("run_observed", lambda: sim.run_observed(
        sim.init_state(inj), *tel(sim, "broadcast"), 1))
    probe("run_observed_prov", lambda: sim.run_observed(
        sim.init_state(inj), None, None, 1,
        prov=sim.provenance_state(provenance.ProvenanceSpec("broadcast"),
                                  inj),
        prov_spec=provenance.ProvenanceSpec("broadcast")))
    probe("inject_mid", lambda: sim.inject_mid(sim.init_state(inj), 0, 0))
    probe("collectives_dcn", lambda: engine.collectives(
        4, mesh, dcn=engine.resolve_dcn_mode("pipelined")))
    from gossip_glomers_tpu_torch.tpu_sim import counter, kafka, scenario, txn

    csim = counter.CounterSim(n, mesh=mesh)
    probe("counter_run_traffic", lambda: csim.run_traffic(
        csim.init_state(), csim.traffic_state(tspec), tspec, 1))
    probe("counter_run_observed", lambda: csim.run_observed(
        csim.init_state(), *tel(csim, "counter"), 1))
    probe("counter_run_observed_prov", lambda: csim.run_observed(
        csim.init_state(), None, None, 1,
        prov=csim.provenance_state(provenance.ProvenanceSpec("counter")),
        prov_spec=provenance.ProvenanceSpec("counter")))
    probe("counter_dcn_mode", lambda: counter.CounterSim(
        n, mesh=mesh, dcn_mode="sync"))
    ksim = kafka.KafkaSim(n, 2, 8, mesh=mesh)
    sends = np.full((1, n, ksim.max_sends), -1, np.int32)
    probe("kafka_run_traffic", lambda: ksim.run_traffic(
        ksim.init_state(), ksim.traffic_state(tspec), tspec, 1))
    probe("kafka_run_observed", lambda: ksim.run_observed(
        ksim.init_state(), *tel(ksim, "kafka"), sends, sends))
    probe("kafka_run_observed_prov", lambda: ksim.run_observed(
        ksim.init_state(), None, None, sends, sends,
        prov=provenance.init_kafka(2, 8, device=mesh.device),
        prov_spec=provenance.ProvenanceSpec("kafka")))
    probe("kafka_batch_round", lambda: kafka._build_batch_round(ksim))
    probe("kafka_dcn_mode", lambda: kafka.KafkaSim(n, 2, 8, mesh=mesh,
                                                   dcn_mode="sync"))
    probe("txn", lambda: txn.TxnSim(n, 4, mesh=mesh))
    probe("scenario_batch", lambda: scenario.run_scenario_batch(
        scenario.ScenarioBatch(workload="counter", scenarios=(
            faults.NemesisSpec(n_nodes=n),)), mesh=mesh))
    return out


# -- the simulator -----------------------------------------------------------


def _topo(topo: str, n: int, kw: dict):
    if topo == "tree":
        return to_padded_neighbors(tree(n, kw.get("branching", 4)))
    if topo == "grid":
        return to_padded_neighbors(grid(n))
    if topo == "line":
        return to_padded_neighbors(line(n))
    if topo == "ring":
        return to_padded_neighbors(ring(n))
    if topo == "circulant":
        return circulant(n, kw["strides"])
    return random_regular(n, 4, seed=3)


def _result(sim, state, rounds) -> dict:
    return {"rounds": int(rounds),
            "received": sim.received_node_major(state),
            "msgs": int(state.msgs),
            "srv": None if state.srv_msgs is None else int(state.srv_msgs)}


def sim_cases(mesh, halo_cases=HALO_CASES) -> dict:
    """The reference's sharded-broadcast cases on this mesh: every run's
    rounds, received set, msgs and srv_msgs."""
    out = {}
    for topo in ("tree", "grid", "rr"):
        n, nv = 64, 48
        sim = broadcast.BroadcastSim(_topo(topo, n, {}), n_values=nv,
                                     mesh=mesh)
        out[("converge", topo)] = _result(
            sim, *sim.run(broadcast.make_inject(n, nv)))
    n, nv = 64, 64
    inject = broadcast.make_inject(n, nv)
    sim = broadcast.BroadcastSim(_topo("grid", n, {}), n_values=nv,
                                 mesh=mesh)
    out["grid_exact"] = _result(sim, *sim.run(inject))
    sim = broadcast.BroadcastSim(_topo("tree", n, {}), n_values=nv,
                                 mesh=mesh)
    out[("fused_vs_step", "run")] = _result(sim, *sim.run(inject))
    out[("fused_vs_step", "run_fused")] = _result(sim,
                                                  *sim.run_fused(inject))
    # a partition window over rounds [0, 10), healed by anti-entropy
    group = np.zeros((1, n), np.int8)
    group[0, : n // 2] = 1
    parts = broadcast.Partitions.from_numpy([0], [10], group)
    inj8 = broadcast.make_inject(n, 8, origins=np.zeros(8, dtype=np.int64))
    sim = broadcast.BroadcastSim(_topo("grid", n, {}), n_values=8,
                                 sync_every=4, parts=parts, mesh=mesh)
    out["partition_heals"] = _result(sim, *sim.run(inj8))
    # the words-major tree with no halo closure: the all-gather fallback
    ex = structured.make_exchange("tree", n)
    sim = broadcast.BroadcastSim(_topo("tree", n, {}), n_values=nv,
                                 mesh=mesh, exchange=ex)
    out[("structured_fallback", "run")] = _result(sim, *sim.run(inject))
    out[("structured_fallback", "run_fused")] = _result(
        sim, *sim.run_fused(inject))
    # the halo path on every reference case
    for topo, hn, kw in halo_cases:
        hinj = broadcast.make_inject(hn, 64)
        sim = broadcast.BroadcastSim(
            _topo(topo, hn, kw), n_values=64, mesh=mesh,
            exchange=structured.make_exchange(topo, hn, **kw),
            sharded_exchange=structured.make_sharded_exchange(
                topo, hn, mesh.size, **kw))
        before = dict(mesh.calls)
        res = _result(sim, *sim.run(hinj))
        res["all_gather"] = mesh.calls["all_gather"] - before.get(
            "all_gather", 0) - 1          # less the final read's
        out[("halo", topo, hn)] = res
        out[("halo_fused", topo, hn)] = _result(sim, *sim.run_fused(hinj))
    # the server ledger on the gather path through sync waves
    sim = broadcast.BroadcastSim(_topo("tree", n, {}), n_values=40,
                                 sync_every=6, mesh=mesh)
    inj40 = broadcast.make_inject(n, 40)
    out[("srv", "run")] = _result(sim, *sim.run(inj40))
    out[("srv", "run_fused")] = _result(sim, *sim.run_fused(inj40))
    return out


def structured_sim_cases(mesh, n: int = 1 << 12) -> dict:
    """``timing.structured_sim(mesh=)`` on the tree with the server ledger
    on and off; the flood twin's fixed trip; the words-major partition
    schedule on the halo path (grid) and the all-gather fallback (a tree
    of 24 nodes: no halo form at 4 shards); the collective calls of the
    tree's halo rounds."""
    out = {}
    inject = broadcast.make_inject(n, 32)
    for srv in (False, True):
        sim = timing.structured_sim("tree", n, 32, sync_every=4,
                                    srv_ledger=srv, mesh=mesh)
        before = dict(mesh.calls)
        state, rounds = sim.run(inject)
        calls = {kind: mesh.calls[kind] - before.get(kind, 0)
                 for kind in ("ppermute", "all_gather", "all_reduce")}
        res = _result(sim, state, rounds)
        res["calls"] = calls
        res["halo"] = sim.sharded_exchange is not None
        out[("tree", srv)] = res
    sim = timing.structured_sim("tree", n, 32, sync_every=1 << 20,
                                mesh=mesh)
    rounds = timing.discover_rounds("tree", n, 32)
    parts = sim.build_fixed(rounds, donate=True)
    state = sim.run_staged_fixed(sim.init_state(inject), rounds,
                                 donate=True)
    out["fixed"] = _result(sim, state, rounds)
    out["fixed"]["flood_twin"] = parts is not None
    out["fixed"]["msgs64"] = timing.flood_msgs64(sim, state)
    for topo, fn in (("grid", 256), ("tree", 24)):
        groups = halo_groups(fn, 5)
        p = broadcast.Partitions.from_numpy([1], [7], groups)
        sim = timing.structured_sim(topo, fn, 16, sync_every=3,
                                    srv_ledger=True, parts=p, mesh=mesh)
        res = _result(sim, *sim.run(broadcast.make_inject(fn, 16)))
        res["halo"] = sim._faulted.sharded_exchange is not None
        out[("faulted", topo)] = res
    return out


def mesh_cases(mesh, seed: int) -> dict:
    """Everything test_torch_mesh.py reads from its 4-rank world."""
    return {"collectives": collective_cases(mesh, seed),
            "halo": halo_primitive_cases(mesh, seed, 8, 3),
            "exchanges": exchange_cases(mesh, seed),
            "tree_parts": tree_halo_parts(mesh, seed, 64, 4, 3),
            "refusals": refusal_cases(mesh)}


#: the 2-rank world's cases: fewer shards than the branching k
P2_TREES = [("tree", 64, {}), ("tree", 256, {"branching": 2}),
            ("tree", 32, {"branching": 8})]


def mesh_cases_p2(mesh, seed: int) -> dict:
    out = {"exchanges": exchange_cases(mesh, seed, P2_TREES, w=3),
           "tree_parts": tree_halo_parts(mesh, seed, 64, 4, 1)}
    n = 64
    sim = broadcast.BroadcastSim(
        _topo("tree", n, {}), n_values=64, sync_every=5, mesh=mesh,
        exchange=structured.make_exchange("tree", n),
        sharded_exchange=structured.make_sharded_exchange("tree", n, 2),
        sharded_sync_diff=structured.make_sharded_sync_diff("tree", n, 2))
    out["sim"] = _result(sim, *sim.run(broadcast.make_inject(n, 64)))
    return out


def sim_world(mesh) -> dict:
    """Everything test_torch_mesh_sim.py reads from its world."""
    return {"sims": sim_cases(mesh), "structured": structured_sim_cases(mesh)}


def hang_rank(mesh):
    """A world that deadlocks: rank 0 waits in an all-reduce that no
    other rank joins."""
    import time

    if mesh.rank == 0:
        mesh.all_reduce(torch.zeros(1))
    time.sleep(3600)


def fail_rank(mesh):
    """A world whose rank 1 fails."""
    if mesh.rank == 1:
        return 1 // 0
    return mesh.rank
