"""Rank-side cases of the fault, delay and counter mesh tests
(tests/test_torch_mesh_faults.py, tests/test_torch_mesh_counter.py):
module-level functions that a spawned rank of ``dcn_worker.spawn_world``
runs as ``fn(mesh)``.  Each world runs its cases on the whole 4-rank
mesh and on a 2-rank mesh of ranks 0 and 1 (a subgroup of the same
world), so one spawn covers both.  Inputs are made from seeds with numpy
by the functions below, which the tests also call to build the JAX
package's runs; results come back as numpy (received sets gathered, so
every rank reports the global ones).  No JAX here: the ranks import this
module."""

import numpy as np
import torch

import torch_mesh_cases as C
from gossip_glomers_tpu_torch.parallel.mesh import Mesh
from gossip_glomers_tpu_torch.parallel.topology import (
    circulant, grid, line, to_padded_neighbors, tree)
from gossip_glomers_tpu_torch.tpu_sim import broadcast, faults, kernels
from gossip_glomers_tpu_torch.tpu_sim import structured as S
from gossip_glomers_tpu_torch.tpu_sim.counter import CounterSim, KVReach

KINDS = ("ppermute", "all_gather", "all_reduce")

# -- the inputs, shared with the JAX side ------------------------------------

#: tests/test_nemesis.py's structured nemesis spec (crash, loss, dup)
NEM_SPEC = dict(n_nodes=64, seed=7, crash=((3, 8, (2, 5, 11)),),
                loss_rate=0.2, loss_until=12, dup_rate=0.15, dup_until=12)
#: tests/test_nemesis.py's SPEC (16 nodes)
SPEC16 = dict(n_nodes=16, seed=7, crash=((3, 8, (2, 5, 11)),),
              loss_rate=0.2, loss_until=10, dup_rate=0.1, dup_until=10)
#: the gather path's partitions + delays + crash + loss composition
COMPOSE16 = dict(n_nodes=16, seed=3, crash=((4, 9, (1, 6)),),
                 loss_rate=0.15, loss_until=12)
#: tests/test_ledger_calibration.py's loss-only spec
LEDGER_SPEC = dict(n_nodes=64, seed=5, loss_rate=0.25, loss_until=10)
#: the counter's crash + loss spec (tests/test_nemesis.py)
COUNTER_SPEC = dict(n_nodes=16, seed=9, crash=((2, 6, (1, 8)),),
                    loss_rate=0.2, loss_until=12)
#: the device KV's spec (tests/test_kvstore.py)
KV_SPEC = dict(n_nodes=16, seed=9, crash=((2, 4, (5,)),), loss_rate=0.15,
               loss_until=6)

DELAYED_CASES = [("tree", 64, {}, (1, 3)),
                 ("circulant", 128, {"strides": [1, 5, 33]},
                  (2, 1, 3, 2, 1, 3)),
                 ("grid", 256, {}, (2, 1, 2, 1)),
                 ("line", 64, {}, (3, 2))]
EDGE_CASES = [("tree", 64, {}, 2),
              ("circulant", 128, {"strides": [1, 5, 33]}, 6),
              ("grid", 256, {}, 4),
              ("line", 64, {}, 2)]
EDGE_FAULTED_CASES = [("tree", 64, 2, {}),
                      ("circulant", 64, 4, {"strides": [1, 5]}),
                      ("grid", 256, 4, {})]
NEM_CASES = [("tree", {}), ("circulant", {"strides": [1, 5]})]
NEM_DELAYED_CASES = [("tree", {}, (1, 3)),
                     ("circulant", {"strides": [1, 5]}, (1, 2, 3, 1))]
#: every topology with a halo form: the bundles' closures on one block
BUNDLE_CASES = [("ring", 64, {}), ("circulant", 128, {"strides": [1, 5, 33]}),
                ("tree", 64, {}), ("tree", 256, {"branching": 2}),
                ("grid", 256, {}), ("line", 64, {})]


def nbrs_of(topo: str, n: int, kw: dict) -> np.ndarray:
    if topo == "tree":
        return to_padded_neighbors(tree(n, kw.get("branching", 4)))
    if topo == "circulant":
        return circulant(n, kw["strides"])
    if topo == "grid":
        return to_padded_neighbors(grid(n))
    if topo == "line":
        return to_padded_neighbors(line(n))
    return C._topo(topo, n, kw)


def half_groups(n: int) -> np.ndarray:
    g = np.zeros((1, n), np.int8)
    g[0, : n // 2] = 1
    return g


def quarter_groups(n: int, cut: int = 4) -> np.ndarray:
    g = np.zeros((1, n), np.int8)
    g[0, :cut] = 1
    return g


def gather_delays_inputs():
    """tests/test_tpu_sim_broadcast.py:386: a 64-node tree, delays 1..3."""
    nbrs = to_padded_neighbors(tree(64))
    delays = np.random.default_rng(0).integers(1, 4, nbrs.shape).astype(
        np.int32)
    return nbrs, delays


def gather_delays_parts_inputs():
    """tests/test_tpu_sim_broadcast.py:411: circulant 1024, a window."""
    n = 1024
    nbrs = circulant(n, [1, 37, 211])
    rng = np.random.default_rng(3)
    delays = rng.integers(1, 4, nbrs.shape).astype(np.int32)
    group = rng.integers(0, 2, n).astype(np.int8)[None, :]
    return nbrs, delays, group


def delayed_faulted_group():
    """tests/test_tpu_sim_broadcast.py:1327's window group."""
    return np.random.default_rng(9).integers(0, 2, 128).astype(
        np.int8)[None, :]


def edge_rows():
    """tests/test_tpu_sim_broadcast.py:1542's rows, in case order."""
    rng = np.random.default_rng(23)
    return [rng.choice([1, 3], size=(d, n)).astype(np.int32)
            for _, n, _, d in EDGE_CASES]


def edge_faulted_rows():
    """tests/test_nemesis.py:780's rows, in case order."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, 4, (d, n)).astype(np.int32)
            for _, n, d, _ in EDGE_FAULTED_CASES]


def compose_delays(nbrs: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.where(nbrs >= 0, rng.integers(1, 4, nbrs.shape),
                    1).astype(np.int32)


def bundle_inputs(i: int, n: int, d: int, w: int = 2, ring: int = 3):
    """One block set of the bundle closures' operands: a payload, a ring,
    delivery rows, per-node counts."""
    rng = np.random.default_rng(100 + i)
    return {"p": C.words((w, n), 7 + i), "hist": C.words((ring, w, n), 8 + i),
            "live": rng.random((d, n)) < 0.6,
            "counts": rng.integers(0, 50, (1, n)).astype(np.int64)}


# -- helpers -------------------------------------------------------------------


# every case function also runs in one process (``mesh=None``, on the
# CPU): the tests hold the ranks' results against that run too


def _calls(mesh, before: dict) -> dict:
    if mesh is None:
        return {}
    return {k: mesh.calls[k] - before.get(k, 0) for k in KINDS}


def _before(mesh) -> dict:
    return {} if mesh is None else dict(mesh.calls)


def _dev(mesh) -> str:
    return "cpu" if mesh is None else str(mesh.device)


def _on(mesh) -> dict:
    """A sim's placement: the mesh, or one process on the CPU."""
    return {"mesh": mesh} if mesh is not None else {"device": "cpu"}


def _shards(mesh):
    return None if mesh is None else mesh.size


def _sub(mesh, k: int):
    """A mesh of the first ``k`` ranks of ``mesh``'s world (every rank
    must call it; the others get None)."""
    import torch.distributed as dist

    if k == mesh.size:
        return mesh
    group = dist.new_group(list(range(k)))
    return Mesh(group, device=mesh.device) if mesh.rank < k else None


def _spec(kw: dict):
    return faults.NemesisSpec(**kw)


def _plan(kw: dict, mesh):
    return faults.NemesisSpec(**kw).compile(device=_dev(mesh))


def _parts(group, start, end, mesh):
    return broadcast.Partitions.from_numpy([start], [end], group).to(
        _dev(mesh))


def _res(sim, state, rounds, **extra) -> dict:
    out = C._result(sim, state, rounds)
    out.update(extra)
    return out


def _ring_local(sim, inject) -> tuple:
    return tuple(sim.init_state(inject).history.shape)


# -- the broadcast sims --------------------------------------------------------


def gather_cases(mesh) -> dict:
    """The gather path's ``delays``, plan, composition and
    ``union_block`` on the mesh."""
    out = {}
    nbrs, delays = gather_delays_inputs()
    inject = broadcast.make_inject(64, 48)
    sim = broadcast.BroadcastSim(nbrs, n_values=48, delays=delays, **_on(mesh))
    ring = _ring_local(sim, inject)
    before = _before(mesh)
    state, rounds = sim.run(inject)
    out["delays"] = _res(sim, state, rounds, ring=ring,
                         calls=_calls(mesh, before))
    out["delays_fused"] = _res(sim, *sim.run_fused(inject))
    nbrs, delays, group = gather_delays_parts_inputs()
    sim = broadcast.BroadcastSim(nbrs, n_values=32, sync_every=6,
                                 parts=_parts(group, 2, 9, mesh),
                                 delays=delays, **_on(mesh))
    out["delays_parts"] = _res(sim, *sim.run_fused(
        broadcast.make_inject(1024, 32)))
    n, nv = 16, 24
    g16 = to_padded_neighbors(grid(n))
    inj16 = broadcast.make_inject(n, nv)
    sim = broadcast.BroadcastSim(g16, n_values=nv, sync_every=4,
                                 fault_plan=_plan(SPEC16, mesh),
                                 parts=_parts(quarter_groups(n), 3, 6, mesh),
                                 srv_ledger=False, **_on(mesh))
    before = _before(mesh)
    state, rounds = sim.run(inj16, max_rounds=200)
    out["plan"] = _res(sim, state, rounds, calls=_calls(mesh, before))
    out["plan_fused"] = _res(sim, *sim.run_fused(inj16, max_rounds=200))
    st, _ = sim.stage(inj16)
    fixed = sim.run_staged_fixed(st, rounds, donate=True)
    out["plan_fixed"] = _res(sim, fixed, rounds)
    sim = broadcast.BroadcastSim(g16, n_values=nv, sync_every=4,
                                 fault_plan=_plan(COMPOSE16, mesh),
                                 parts=_parts(quarter_groups(n), 3, 6, mesh),
                                 delays=compose_delays(g16), **_on(mesh))
    out["compose"] = _res(sim, *sim.run(inj16, max_rounds=400))
    t64 = to_padded_neighbors(tree(64))
    inj = broadcast.make_inject(64, 48)
    for ub in (None, 4):
        sim = broadcast.BroadcastSim(t64, n_values=48, sync_every=4,
                                     fault_plan=_plan(NEM_SPEC, mesh),
                                     srv_ledger=False, union_block=ub,
                                     **_on(mesh))
        out[("union_block", ub)] = _res(sim, *sim.run(inj, max_rounds=200),
                                        ub=sim._ub)
    # the loss-only and crash server ledgers of the gather path
    for name, spec in (("ledger_loss", LEDGER_SPEC),
                       ("ledger_crash", dict(LEDGER_SPEC,
                                             crash=((2, 5, (3, 40)),)))):
        sim = broadcast.BroadcastSim(t64, n_values=48, sync_every=4,
                                     fault_plan=_plan(spec, mesh), **_on(mesh))
        out[name] = _res(sim, *sim.run(inj, max_rounds=200))
    return out


def structured_delay_cases(mesh) -> dict:
    """``delayed`` (plain and under a window) and ``edge_delayed`` (plain
    and under a window) through the bundles' halo closures."""
    out = {}
    k = _shards(mesh)
    for topo, n, kw, dd in DELAYED_CASES:
        inject = broadcast.make_inject(n, 48)
        dl = S.make_delayed(topo, n, dd, n_shards=k, **kw)
        sim = broadcast.BroadcastSim(
            nbrs_of(topo, n, kw), n_values=48, sync_every=6, **_on(mesh),
            exchange=S.make_exchange(topo, n, **kw),
            sync_diff=S.make_sync_diff(topo, n, **kw),
            sharded_sync_diff=None if k is None
            else S.make_sharded_sync_diff(topo, n, k, **kw),
            delayed=dl)
        ring = _ring_local(sim, inject)
        before = _before(mesh)
        state, rounds = sim.run(inject)
        out[("delayed", topo)] = _res(sim, state, rounds, ring=ring,
                                      calls=_calls(mesh, before))
    n, strides, dd = 128, [1, 5, 33], (1, 2, 3, 1, 2, 3)
    group = delayed_faulted_group()
    sim = broadcast.BroadcastSim(
        circulant(n, strides), n_values=48, sync_every=6,
        parts=_parts(group, 2, 9, mesh), **_on(mesh),
        exchange=S.make_exchange("circulant", n, strides=strides),
        delayed=S.make_delayed_faulted("circulant", n, dd, group,
                                       n_shards=k, strides=strides))
    out["delayed_faulted"] = _res(sim, *sim.run(broadcast.make_inject(n, 48)))
    for (topo, n, kw, _), rows in zip(EDGE_CASES, edge_rows()):
        inject = broadcast.make_inject(n, 48)
        sim = broadcast.BroadcastSim(
            nbrs_of(topo, n, kw), n_values=48, sync_every=6, **_on(mesh),
            exchange=S.make_exchange(topo, n, **kw),
            sync_diff=S.make_sync_diff(topo, n, **kw),
            sharded_sync_diff=None if k is None
            else S.make_sharded_sync_diff(topo, n, k, **kw),
            edge_delayed=S.make_edge_delayed(topo, n, rows, n_shards=k,
                                             **kw))
        ring = _ring_local(sim, inject)
        state, rounds = sim.run(inject)
        out[("edge", topo)] = _res(sim, state, rounds, ring=ring)
        out[("edge_fused", topo)] = _res(sim, *sim.run_fused(inject))
        st0, _ = sim.stage(inject)
        out[("edge_fixed", topo)] = _res(
            sim, sim.run_staged_fixed(st0, rounds), rounds)
    for (topo, n, _, kw), rows in zip(EDGE_FAULTED_CASES,
                                      edge_faulted_rows()):
        groups = half_groups(n)
        sim = broadcast.BroadcastSim(
            nbrs_of(topo, n, kw), n_values=48, sync_every=4,
            parts=_parts(groups, 2, 9, mesh), **_on(mesh),
            exchange=S.make_exchange(topo, n, **kw),
            edge_delayed=S.make_edge_delayed_faulted(
                topo, n, rows, groups, n_shards=k, **kw))
        out[("edge_faulted", topo)] = _res(
            sim, *sim.run(broadcast.make_inject(n, 48), max_rounds=400))
    return out


def nemesis_cases(mesh) -> dict:
    """The structured nemesis on the halo path and the all-gather
    fallback, with and without ``dir_delays``; the loss-only server
    ledger round by round."""
    out = {}
    k, n, nv = _shards(mesh), 64, 48
    inject = broadcast.make_inject(n, nv)
    groups = half_groups(n)
    for topo, kw in NEM_CASES:
        for shards in (k, None):
            nem = S.make_nemesis(topo, n, _spec(NEM_SPEC), groups=groups,
                                 n_shards=shards, device=_dev(mesh),
                                 **kw)
            sim = broadcast.BroadcastSim(
                nbrs_of(topo, n, kw), n_values=nv, sync_every=4,
                parts=_parts(groups, 2, 9, mesh), **_on(mesh),
                exchange=S.make_exchange(topo, n, **kw),
                fault_plan=_plan(NEM_SPEC, mesh), nemesis=nem,
                srv_ledger=False)
            before = _before(mesh)
            state, rounds = sim.run(inject, max_rounds=200)
            out[("nem", topo, shards)] = _res(
                sim, state, rounds, calls=_calls(mesh, before),
                halo=nem.sharded_exchange is not None)
            out[("nem_fused", topo, shards)] = _res(
                sim, *sim.run_fused(inject, max_rounds=200))
            st0, _ = sim.stage(inject)
            out[("nem_fixed", topo, shards)] = _res(
                sim, sim.run_staged_fixed(st0, rounds, donate=True), rounds)
    for topo, kw, dd in NEM_DELAYED_CASES:
        for shards in (k, None):
            nem = S.make_nemesis(topo, n, _spec(NEM_SPEC), groups=groups,
                                 dir_delays=dd, n_shards=shards,
                                 device=_dev(mesh), **kw)
            sim = broadcast.BroadcastSim(
                nbrs_of(topo, n, kw), n_values=nv, sync_every=4,
                parts=_parts(groups, 2, 9, mesh), **_on(mesh),
                exchange=S.make_exchange(topo, n, **kw),
                fault_plan=_plan(NEM_SPEC, mesh), nemesis=nem,
                srv_ledger=False)
            out[("nem_delayed", topo, shards)] = _res(
                sim, *sim.run(inject, max_rounds=400))
    # the loss-only server ledger on the halo path, round by round
    t64 = nbrs_of("tree", n, {})
    sim = broadcast.BroadcastSim(
        t64, n_values=nv, sync_every=4, fault_plan=_plan(LEDGER_SPEC, mesh),
        **_on(mesh), exchange=S.make_exchange("tree", n),
        sharded_exchange=None if k is None
        else S.make_sharded_exchange("tree", n, k),
        nemesis=S.make_nemesis("tree", n, _spec(LEDGER_SPEC), n_shards=k,
                               device=_dev(mesh)))
    state = sim.init_state(inject)
    srv, msgs = [], []
    for _ in range(12):
        state = sim.step(state)
        srv.append(sim.server_msgs(state))
        msgs.append(int(state.msgs))
    out["ledger"] = {"srv": srv, "msgs": msgs,
                     "received": sim.received_node_major(state)}
    return out


def bundle_cases(mesh) -> dict:
    """Each bundle's halo closures on one random block set: the
    nemesis's exchange and count relocation, the delay bundles'
    exchanges at a few rounds, and the collectives they make."""
    out = {}
    k = mesh.size
    dev = mesh.device
    spec_kw = dict(seed=3, loss_rate=0.3, loss_until=5)
    for i, (topo, n, kw) in enumerate(BUNDLE_CASES):
        b = n // k
        cols = slice(mesh.rank * b, (mesh.rank + 1) * b)
        nem = S.make_nemesis(topo, n, faults.NemesisSpec(n_nodes=n,
                                                         **spec_kw),
                             n_shards=k, device=str(dev), **kw)
        d = nem.arrs.exists.shape[0]
        x = bundle_inputs(i, n, d)
        p = C._t(x["p"][:, cols], mesh)
        hist = C._t(np.ascontiguousarray(x["hist"][..., cols]), mesh)
        lv = kernels.pack_bits(torch.from_numpy(
            np.ascontiguousarray(x["live"][:, cols]))).to(dev)
        counts = torch.from_numpy(x["counts"][:, cols].copy()).to(dev)
        before = _before(mesh)
        res = {"nem_exchange": C._np(nem.sharded_exchange.bind(mesh)(p, lv)),
               "nem_calls": _calls(mesh, before)}
        res["nem_src_pc"] = [nem.sharded_src_pc.bind(mesh)(j, counts).cpu()
                             .numpy() for j in range(d)]
        dcls = S._n_classes(topo, n, **kw)
        dd = tuple(1 + (j % 3) for j in range(dcls))
        dl = S.make_delayed(topo, n, dd, n_shards=k, **kw).sharded_exchange
        res["delayed"] = [C._np(dl.bind(mesh)(hist, t)) for t in (0, 1, 5)]
        rows = np.random.default_rng(200 + i).integers(
            1, 4, (dcls, n)).astype(np.int32)
        ed = S.make_edge_delayed(topo, n, rows, n_shards=k, **kw)
        crows = ed.class_rows(dev, cols)
        res["edge"] = [C._np(ed.sharded_exchange.bind(mesh)(hist, t, crows))
                       for t in (0, 2, 5)]
        out[(topo, n)] = res
    return out


def refusal_cases(mesh) -> dict:
    """The ValueErrors a mesh sim raises for bundles without their halo
    closures (the reference's), as (class name, message)."""
    out = {}
    n = 64
    nbrs = nbrs_of("tree", n, {})
    kw = dict(n_values=8, mesh=mesh, exchange=S.make_exchange("tree", n))
    for name, extra in (
            ("delayed", dict(delayed=S.make_delayed("tree", n, (1, 2)))),
            ("edge_delayed", dict(edge_delayed=S.make_edge_delayed(
                "tree", n, np.ones((2, n), np.int32))))):
        try:
            broadcast.BroadcastSim(nbrs, **kw, **extra)
            out[name] = None
        except Exception as e:        # the class and text are the result
            out[name] = (type(e).__name__, str(e))
    return out


def fault_world(mesh) -> dict:
    """Everything test_torch_mesh_faults.py reads from its world: every
    case on the 4-rank mesh, the nemesis, delay and bundle cases on the
    2-rank mesh of ranks 0 and 1."""
    out = {4: {"gather": gather_cases(mesh),
               "delays": structured_delay_cases(mesh),
               "nemesis": nemesis_cases(mesh),
               "bundles": bundle_cases(mesh),
               "refusals": refusal_cases(mesh)}}
    m2 = _sub(mesh, 2)
    if m2 is not None:
        out[2] = {"delays": structured_delay_cases(m2),
                  "nemesis": nemesis_cases(m2),
                  "bundles": bundle_cases(m2)}
    mesh.agree(True)      # ranks 2 and 3 wait for the 2-rank cases
    return out


# -- the counter ---------------------------------------------------------------


def counter_deltas(n: int, seed: int | None = None) -> np.ndarray:
    if seed is None:
        return np.arange(1, n + 1, dtype=np.int32)
    return np.random.default_rng(seed).integers(0, 5, n).astype(np.int32)


def _cstate(sim, st) -> dict:
    return {"pending": sim.mesh.all_gather(st.pending).cpu().numpy()
            if sim.mesh is not None else st.pending.cpu().numpy(),
            "cached": sim.reads(st), "kv": int(st.kv), "t": int(st.t),
            "msgs": int(st.msgs)}


def counter_cases(mesh) -> dict:
    """The reference's counter mesh cases on this mesh: every run's
    pending, cached, kv, t and msgs (and the device KV's rows)."""
    out = {}
    dev = _dev(mesh)
    # tests/test_tpu_sim_programs.py:57 and test_engine.py:188
    sim = CounterSim(64, mode="cas", poll_every=2, **_on(mesh))
    out["programs"] = _cstate(sim, sim.run(sim.add(sim.init_state(),
                                                   counter_deltas(64, 0)), 60))
    out["sharded_fused"] = _cstate(sim, sim.run_fused(
        sim.add(sim.init_state(), counter_deltas(64, 7)), 20))
    # test_engine.py:169: stepwise, run and run_fused
    sim = CounterSim(16, mode="cas", poll_every=2, seed=3, **_on(mesh))
    st = sim.add(sim.init_state(), counter_deltas(16))
    for _ in range(12):
        st = sim.step(st)
    out["engine_step"] = _cstate(sim, st)
    out["engine_run"] = _cstate(sim, sim.run(
        sim.add(sim.init_state(), counter_deltas(16)), 12))
    out["engine_fused"] = _cstate(sim, sim.run_fused(
        sim.add(sim.init_state(), counter_deltas(16)), 12))
    # both modes and both keys under the crash + loss plan, and a KV
    # window
    blocked = np.zeros((1, 16), bool)
    blocked[0, :4] = True
    sched = KVReach.from_numpy([3], [9], blocked)
    for mode in ("cas", "allreduce"):
        for key in ("packed", "wide"):
            sim = CounterSim(16, mode=mode, poll_every=2, winner_key=key,
                             fault_plan=_plan(COUNTER_SPEC, mesh),
                             kv_sched=sched, **_on(mesh))
            before = _before(mesh)
            st = sim.run_fused(sim.add(sim.init_state(),
                                       counter_deltas(16)), 24)
            calls = _calls(mesh, before)
            out[("plan", mode, key)] = dict(_cstate(sim, st), calls=calls)
    # test_nemesis.py:410: the allreduce fault gate in slabs
    for ub in ("materialized", 2):
        sim = CounterSim(16, mode="allreduce", poll_every=2,
                         fault_plan=_plan(COUNTER_SPEC, mesh),
                         union_block=ub, **_on(mesh))
        st = sim.add(sim.init_state(), counter_deltas(16))
        for _ in range(20):
            st = sim.step(st)
        out[("blocked", ub)] = _cstate(sim, st)
    # test_kvstore.py:182: the device KV, round by round
    sim = CounterSim(16, mode="cas", poll_every=2, seed=3,
                     fault_plan=_plan(KV_SPEC, mesh), kv_backend="device",
                     **_on(mesh))
    st = sim.add(sim.init_state(), counter_deltas(16))
    rounds = []
    for _ in range(10):
        before = _before(mesh)
        st = sim.step(st)
        calls = _calls(mesh, before)
        vals = st.rows.vals if mesh is None else mesh.all_gather(
            st.rows.vals)
        rounds.append(dict(_cstate(sim, st), calls=calls,
                           vals=vals.cpu().numpy()))
    out["device_kv"] = rounds
    # kv_amnesia and the stale coins (cas), as the chip's device-KV phase
    sim = CounterSim(16, mode="cas", poll_every=2, seed=7,
                     fault_plan=faults.NemesisSpec(
                         n_nodes=16, seed=2, crash=((1, 3, (4, 11)),),
                         loss_rate=0.1, loss_until=8).compile(device=dev),
                     kv_backend="device", kv_amnesia=True, stale_prob=0.4,
                     stale_until=12, union_block=4, **_on(mesh))
    out["amnesia_stale"] = _cstate(sim, sim.run(
        sim.add(sim.init_state(), counter_deltas(16)), 24))
    return out


def counter_world(mesh) -> dict:
    """Everything test_torch_mesh_counter.py reads: the counter cases on
    the 4-rank mesh and on the 2-rank mesh of ranks 0 and 1, and the
    ``sims`` task's counter half on the 4-rank mesh."""
    from gossip_glomers_tpu_torch.parallel import dcn_worker

    out = {4: counter_cases(mesh),
           "sims": dcn_worker._task_sims(mesh, mesh.device, ("counter",))}
    m2 = _sub(mesh, 2)
    if m2 is not None:
        out[2] = counter_cases(m2)
    mesh.agree(True)      # ranks 2 and 3 wait for the 2-rank cases
    return out
