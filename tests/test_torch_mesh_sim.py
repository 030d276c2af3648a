"""``BroadcastSim(mesh=)`` against the JAX package's sharded
BroadcastSim, on the reference's own sharded-broadcast cases
(tests/test_tpu_sim_broadcast.py: ``test_sharded_topologies_converge``,
``test_sharded_matches_single_device_exactly``, ``test_fused_matches_
stepwise``, ``test_partition_heals_sharded``, ``test_structured_sharded_
and_fused_match``, ``test_halo_sharded_exchange_matches_reference``,
``test_srv_ledger_sharded_matches_single_device``): rounds, ``received``,
``msgs`` and ``srv_msgs`` equal, bit for bit.  Also
``timing.structured_sim(mesh=)`` on a 4,096-node tree (server ledger on
and off, the flood twin's fixed trip) against the port's one-process run,
and the words-major partition schedule on the halo path and the
all-gather fallback against the JAX package.

The port runs in one spawned world of 4 gloo ranks on the CPU
(``torch_mesh_cases``); the JAX package on ``pick_mesh(max_axis=4)`` of
its virtual-device test mesh."""

import numpy as np
import pytest

import torch_mesh_cases as C
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.parallel.topology import (
    circulant as jcirculant, grid as jgrid, line as jline,
    random_regular as jrandom_regular, ring as jring,
    to_padded_neighbors as jpad, tree as jtree)
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import broadcast, timing

P_RANKS = 4
WORLD_TIMEOUT = 90.0


@pytest.fixture(scope="module")
def world():
    ranks = dcn_worker.spawn_world(C.sim_world, P_RANKS, backend="gloo",
                                   device="cpu", timeout=WORLD_TIMEOUT)
    # every rank took the same rounds and ledgers, and read the same
    # gathered received sets
    for r in ranks[1:]:
        for part in ("sims", "structured"):
            for key, val in ranks[0][part].items():
                other = r[part][key]
                assert {f: other[f] for f in ("rounds", "msgs", "srv")} \
                    == {f: val[f] for f in ("rounds", "msgs", "srv")}, key
                np.testing.assert_array_equal(other["received"],
                                              val["received"])
    return ranks[0]


def _jnbrs(topo, n, kw):
    if topo == "tree":
        return jpad(jtree(n, kw.get("branching", 4)))
    if topo == "grid":
        return jpad(jgrid(n))
    if topo == "line":
        return jpad(jline(n))
    if topo == "ring":
        return jpad(jring(n))
    if topo == "circulant":
        return jcirculant(n, kw["strides"])
    return jrandom_regular(n, 4, seed=3)


def _same(mine, sim, state, rounds, srv=True):
    assert mine["rounds"] == int(rounds)
    np.testing.assert_array_equal(mine["received"],
                                  np.asarray(sim.received_node_major(state)))
    assert mine["msgs"] == int(state.msgs)
    want_srv = None if state.srv_msgs is None else int(state.srv_msgs)
    assert mine["srv"] == want_srv


def _mesh():
    return jpick_mesh(max_axis=P_RANKS)


@pytest.mark.parametrize("topo", ["tree", "grid", "rr"])
def test_sharded_topologies_converge(world, topo):
    n, nv = 64, 48
    sim = jbc.BroadcastSim(_jnbrs(topo, n, {}), n_values=nv, mesh=_mesh())
    state, rounds = sim.run(jbc.make_inject(n, nv))
    _same(world["sims"][("converge", topo)], sim, state, rounds)


def test_sharded_matches_single_device_exactly(world):
    n, nv = 64, 64
    sim = jbc.BroadcastSim(_jnbrs("grid", n, {}), n_values=nv, mesh=_mesh())
    _same(world["sims"]["grid_exact"], sim,
          *sim.run(jbc.make_inject(n, nv)))


def test_fused_matches_stepwise(world):
    n, nv = 64, 64
    sim = jbc.BroadcastSim(_jnbrs("tree", n, {}), n_values=nv, mesh=_mesh())
    inject = jbc.make_inject(n, nv)
    _same(world["sims"][("fused_vs_step", "run")], sim, *sim.run(inject))
    _same(world["sims"][("fused_vs_step", "run_fused")], sim,
          *sim.run_fused(inject))


def test_partition_heals_sharded(world):
    import jax.numpy as jnp

    n = 64
    group = np.zeros((1, n), np.int8)
    group[0, : n // 2] = 1
    parts = jbc.Partitions(jnp.array([0], jnp.int32),
                           jnp.array([10], jnp.int32), jnp.asarray(group))
    sim = jbc.BroadcastSim(_jnbrs("grid", n, {}), n_values=8, sync_every=4,
                           parts=parts, mesh=_mesh())
    inject = jbc.make_inject(n, 8, origins=np.zeros(8, dtype=np.int64))
    state, rounds = sim.run(inject)
    assert rounds > 10
    _same(world["sims"]["partition_heals"], sim, state, rounds)


def test_structured_sharded_and_fused_match(world):
    # the words-major tree with no halo closure: the all-gather fallback
    n, nv = 64, 64
    sim = jbc.BroadcastSim(_jnbrs("tree", n, {}), n_values=nv, mesh=_mesh(),
                           exchange=jst.make_exchange("tree", n))
    inject = jbc.make_inject(n, nv)
    _same(world["sims"][("structured_fallback", "run")], sim,
          *sim.run(inject))
    _same(world["sims"][("structured_fallback", "run_fused")], sim,
          *sim.run_fused(inject))


@pytest.mark.parametrize("case", C.HALO_CASES,
                         ids=[f"{t}-{n}" for t, n, _ in C.HALO_CASES])
def test_halo_sharded_sims_match_reference(world, case):
    topo, n, kw = case
    sim = jbc.BroadcastSim(
        _jnbrs(topo, n, kw), n_values=64, mesh=_mesh(),
        exchange=jst.make_exchange(topo, n, **kw),
        sharded_exchange=jst.make_sharded_exchange(topo, n, P_RANKS, **kw))
    inject = jbc.make_inject(n, 64)
    mine = world["sims"][("halo", topo, n)]
    _same(mine, sim, *sim.run(inject))
    assert mine["all_gather"] == 0       # the halo rounds gather nothing
    _same(world["sims"][("halo_fused", topo, n)], sim,
          *sim.run_fused(inject))


def test_srv_ledger_sharded_matches_single_device(world):
    n, nv = 64, 40
    sim = jbc.BroadcastSim(_jnbrs("tree", n, {}), n_values=nv, sync_every=6,
                           mesh=_mesh())
    inject = jbc.make_inject(n, nv)
    state, rounds = sim.run(inject)
    _same(world["sims"][("srv", "run")], sim, state, rounds)
    _same(world["sims"][("srv", "run_fused")], sim, *sim.run_fused(inject))
    ref = jbc.BroadcastSim(_jnbrs("tree", n, {}), n_values=nv, sync_every=6)
    s1, _ = ref.run(inject)
    assert world["sims"][("srv", "run")]["srv"] == ref.server_msgs(s1)


@pytest.mark.parametrize("srv", (False, True))
def test_structured_sim_on_mesh_matches_one_process(world, srv):
    n = 1 << 12
    mine = world["structured"][("tree", srv)]
    sim = timing.structured_sim("tree", n, 32, sync_every=4,
                                srv_ledger=srv, device="cpu", mesh=None)
    state, rounds = sim.run(broadcast.make_inject(n, 32))
    assert mine["halo"]
    assert mine["rounds"] == rounds
    np.testing.assert_array_equal(mine["received"],
                                  sim.received_node_major(state))
    assert mine["msgs"] == int(state.msgs)
    assert mine["srv"] == (int(state.srv_msgs) if srv else None)
    # the tree's halo rounds: ppermutes, and all-reduces only for the
    # ledgers and the convergence flags (one read gathers at the end)
    assert mine["calls"]["all_gather"] == 0
    assert mine["calls"]["ppermute"] > 0


def test_flood_twin_fixed_trip_matches_one_process(world):
    n = 1 << 12
    mine = world["structured"]["fixed"]
    rounds = timing.discover_rounds("tree", n, 32)
    sim = timing.structured_sim("tree", n, 32, sync_every=1 << 20,
                                device="cpu", mesh=None)
    state = sim.run_staged_fixed(sim.init_state(broadcast.make_inject(n, 32)),
                                 rounds)
    assert mine["flood_twin"]
    np.testing.assert_array_equal(mine["received"],
                                  sim.received_node_major(state))
    assert mine["msgs"] == int(state.msgs)
    assert mine["msgs64"] == timing.flood_msgs64(sim, state)


@pytest.mark.parametrize("topo,n,halo", [("grid", 256, True),
                                         ("tree", 24, False)])
def test_words_major_partitions_on_mesh_match_reference(world, topo, n,
                                                        halo):
    import jax.numpy as jnp

    mine = world["structured"][("faulted", topo)]
    assert mine["halo"] is halo
    groups = C.halo_groups(n, 5)
    parts = jbc.Partitions(jnp.array([1], jnp.int32),
                           jnp.array([7], jnp.int32), jnp.asarray(groups))
    mesh = _mesh()
    sim = jbc.BroadcastSim(
        _jnbrs(topo, n, {}), n_values=16, sync_every=3, parts=parts,
        mesh=mesh, exchange=jst.make_exchange(topo, n),
        sharded_exchange=jst.make_sharded_exchange(topo, n, P_RANKS),
        srv_ledger=True, sync_diff=jst.make_sync_diff(topo, n),
        sharded_sync_diff=jst.make_sharded_sync_diff(topo, n, P_RANKS),
        faulted=jst.make_faulted(topo, n, groups, n_shards=P_RANKS))
    _same(mine, sim, *sim.run(jbc.make_inject(n, 16)))
