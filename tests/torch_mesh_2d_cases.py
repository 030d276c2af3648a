"""Rank-side cases of the words-axis mesh tests: module-level functions
that a spawned rank of ``dcn_worker.spawn_world`` runs as ``fn(mesh,
...)``.  :func:`words_world` runs the broadcast simulator on a 2 x 2
``("nodes", "words")`` mesh of the 4-rank world (both layouts, the halo
path, the all-gather fallback, partitions, the server ledger, the
nemesis bundle, every driver), on the 1-D words mesh, and the sims that
refuse a words mesh.

Every input is made from a seed with numpy, identically on every rank
(:data:`WORD_CASES` names them for the tests' JAX twins); each function
returns this rank's results as host values.  No JAX here: the ranks
import this module."""

import numpy as np
import torch

from gossip_glomers_tpu_torch.parallel import mesh as pmesh
from gossip_glomers_tpu_torch.parallel.topology import (
    grid, to_padded_neighbors, tree)
from gossip_glomers_tpu_torch.tpu_sim import broadcast, faults, structured

#: the words-mesh broadcast cases: name -> (topology, n, n_values,
#: sync_every, how); ``how`` names the layout and mode
WORD_CASES = {
    "gather_grid": ("grid", 64, 64, 8, "gather"),
    "gather_tree_fused": ("tree", 64, 64, 8, "gather_fused"),
    "gather_parts": ("grid", 64, 64, 4, "gather_parts"),
    "gather_plan": ("grid", 64, 64, 4, "gather_plan"),
    "wm_tree_halo": ("tree", 64, 128, 4, "halo"),
    "wm_tree_flood": ("tree", 64, 128, 64, "halo_flood"),
    "wm_grid_fallback": ("grid", 64, 128, 4, "fallback"),
    "wm_tree_faulted": ("tree", 64, 128, 4, "faulted"),
    "wm_tree_nemesis": ("tree", 64, 128, 4, "nemesis"),
}

#: the nemesis and plan spec of the words-mesh cases
NEM_SPEC = dict(seed=11, crash=((2, 6, (3, 17)),), loss_rate=0.15,
                loss_until=8)


def words_mesh(world):
    """The 2 x 2 ``("nodes", "words")`` mesh of a 4-rank world."""
    return pmesh.make_mesh((2, 2), ("nodes", "words"), device=world.device)


def half_groups(n: int) -> np.ndarray:
    g = np.zeros((1, n), np.int8)
    g[0, n // 2:] = 1
    return g


def nbrs_of(topo: str, n: int) -> np.ndarray:
    return to_padded_neighbors(tree(n) if topo == "tree" else grid(n))


def word_sim(name: str, mesh, device):
    """The BroadcastSim of a :data:`WORD_CASES` case on ``mesh`` (None:
    one process on ``device``)."""
    topo, n, nv, se, how = WORD_CASES[name]
    nbrs = nbrs_of(topo, n)
    kw = dict(n_values=nv, sync_every=se, mesh=mesh, device=device)
    shards = None if mesh is None else 2
    if how.startswith("gather"):
        if how == "gather_parts":
            kw["parts"] = broadcast.Partitions.from_numpy(
                [1], [6], half_groups(n))
        if how == "gather_plan":
            spec = faults.NemesisSpec(n_nodes=n, **NEM_SPEC)
            kw.update(fault_plan=spec.compile(device=str(device)),
                      srv_ledger=False)
        return broadcast.BroadcastSim(nbrs, **kw)
    kw["exchange"] = structured.make_exchange(topo, n)
    if how in ("halo", "halo_flood") and mesh is not None:
        kw["sharded_exchange"] = structured.make_sharded_exchange(
            topo, n, shards)
        kw["sharded_sync_diff"] = structured.make_sharded_sync_diff(
            topo, n, shards)
    if how == "halo" and mesh is None:
        kw["sync_diff"] = structured.make_sync_diff(topo, n)
    if how == "halo_flood":
        kw["srv_ledger"] = False
    if how == "fallback":
        kw["srv_ledger"] = False
    if how == "faulted":
        groups = half_groups(n)
        kw["parts"] = broadcast.Partitions.from_numpy([1], [6], groups)
        kw["faulted"] = structured.make_faulted(topo, n, groups,
                                                n_shards=shards)
    if how == "nemesis":
        groups = half_groups(n)
        spec = faults.NemesisSpec(n_nodes=n, **NEM_SPEC)
        kw.update(parts=broadcast.Partitions.from_numpy([1], [6], groups),
                  fault_plan=spec.compile(device=str(device)),
                  nemesis=structured.make_nemesis(
                      topo, n, spec, groups=groups, n_shards=shards,
                      device=str(device)),
                  srv_ledger=False)
    return broadcast.BroadcastSim(nbrs, **kw)


def _res(sim, state, rounds) -> dict:
    return {"rounds": int(rounds),
            "received": sim.received_node_major(state),
            "msgs": int(state.msgs),
            "srv": None if state.srv_msgs is None else int(state.srv_msgs)}


def run_word_case(name: str, mesh, device) -> dict:
    """A case's drivers: ``run`` (``run_fused`` for the fused cases), and
    for the structured ones ``stage`` / ``run_staged`` /
    ``run_staged_fixed`` at the converged round count."""
    topo, n, nv, _, how = WORD_CASES[name]
    sim = word_sim(name, mesh, device)
    inject = broadcast.make_inject(n, nv)
    out = {}
    if how in ("gather_fused", "halo_flood"):
        state, rounds = sim.run_fused(inject)
    else:
        state, rounds = sim.run(inject)
    out["run"] = _res(sim, state, rounds)
    out["read0"] = sim.read(state)[0]
    if how in ("halo", "halo_flood", "fallback", "faulted"):
        st, tgt = sim.stage(inject)
        s2 = sim.run_staged(st, tgt)
        out["staged"] = _res(sim, s2, s2.t)
        st, _ = sim.stage(inject)
        s3 = sim.run_staged_fixed(st, rounds)
        out["fixed"] = _res(sim, s3, rounds)
        out["flood_path"] = sim.build_fixed(rounds) is not None
    return out


def words_cases(mesh) -> dict:
    """Every :data:`WORD_CASES` case on ``mesh`` (a words mesh)."""
    return {name: run_word_case(name, mesh, mesh.device)
            for name in WORD_CASES}


def inject_mid_case(mesh, device) -> dict:
    """``inject_mid`` on the gather path, then the run to the end."""
    n, nv = 64, 64
    sim = broadcast.BroadcastSim(nbrs_of("grid", n), n_values=nv,
                                 sync_every=4, mesh=mesh, device=device)
    inject = np.zeros((n, 2), np.uint32)
    inject[5, 0] = 1
    state = sim.init_state(inject)
    state = sim.step(sim.step(state))
    state = sim.inject_mid(state, 60, 40)
    target = torch.zeros(2, dtype=torch.int32)
    target[0], target[1] = 1, 1 << 8
    if mesh is not None and "words" in mesh.axis_names:
        w = mesh.axis_index("words")
        target = target[w:w + 1]
    target = target.to(sim.device)
    for _ in range(64):
        if sim.converged(state, target):
            break
        state = sim.step(state)
    return _res(sim, state, state.t)


def word_refusals(mesh) -> dict:
    """What a words mesh refuses: the sims other than the broadcast
    simulator, provenance and the traffic drivers (each its message)."""
    from gossip_glomers_tpu_torch.tpu_sim import (counter, echo, kafka,
                                                  provenance, traffic, txn,
                                                  unique_ids)

    n = 16
    out = {}

    def probe(name, fn):
        try:
            fn()
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)

    probe("counter", lambda: counter.CounterSim(n, mesh=mesh))
    probe("kafka", lambda: kafka.KafkaSim(n, 2, 8, mesh=mesh))
    probe("txn", lambda: txn.TxnSim(n, 4, mesh=mesh))
    probe("ids", lambda: unique_ids.UniqueIdsSim(n, mesh=mesh))
    probe("echo", lambda: echo.EchoSim(n, mesh=mesh))
    sim = broadcast.BroadcastSim(nbrs_of("grid", n), n_values=64,
                                 srv_ledger=False, mesh=mesh)
    inj = np.zeros((n, 2), np.uint32)
    pspec = provenance.ProvenanceSpec("broadcast")
    probe("provenance", lambda: sim.run_observed(
        sim.init_state(inj), None, None, 1,
        prov=provenance.init_broadcast(n // 2, 64, inj[:n // 2],
                                       device=mesh.device),
        prov_spec=pspec))
    tspec = traffic.TrafficSpec(n_nodes=n, n_clients=2, ops_per_client=1,
                                until=2)
    probe("traffic", lambda: sim.run_traffic(
        sim.init_state(inj), None, tspec, 1))
    return out


def one_d_words(world) -> dict | None:
    """The 1-D words mesh of :func:`.mesh.pick_mesh` (4 word shards,
    the node axis whole on every rank): the gather path and the
    structured one without a halo closure."""
    mesh = pmesh.pick_mesh(axis_name="words", device=world.device)
    out = {"shape": mesh.shape, "node_axis": list(mesh.node_axis)}
    n, nv = 64, 128
    for name, kw in (("gather", {}),
                     ("wm", {"exchange": structured.make_exchange(
                         "tree", n), "srv_ledger": False})):
        sim = broadcast.BroadcastSim(nbrs_of("tree", n), n_values=nv,
                                     sync_every=4, mesh=mesh, **kw)
        state, rounds = sim.run(broadcast.make_inject(n, nv))
        out[name] = _res(sim, state, rounds)
    return out


def words_world(world) -> dict:
    """The words-axis rank body: the 2 x 2 mesh's shape and coordinates,
    every case, ``inject_mid``, the refusals and the 1-D words mesh."""
    mesh = words_mesh(world)
    before = dict(mesh.calls_by_axis)
    out = {"shape": mesh.shape, "coords": mesh.coords,
           "node_axis": list(mesh.node_axis),
           "cases": words_cases(mesh),
           "inject_mid": inject_mid_case(mesh, mesh.device),
           "refusals": word_refusals(mesh)}
    used = {f"{k}@{a}" for (k, a), v in mesh.calls_by_axis.items()
            if v > before.get((k, a), 0)}
    out["axes_used"] = sorted(used)
    whole = np.arange(16 * 4, dtype=np.int32).reshape(16, 4)
    out["shard_put"] = pmesh.shard_put(whole, mesh, axis=0,
                                       words_axis=1).numpy()
    out["one_d"] = one_d_words(world)
    return out


def one_process_words() -> dict:
    """The port's one-process twins of :func:`words_world`'s runs."""
    return {"cases": words_cases_off(),
            "inject_mid": inject_mid_case(None, "cpu")}


def words_cases_off() -> dict:
    return {name: run_word_case(name, None, "cpu") for name in WORD_CASES}
