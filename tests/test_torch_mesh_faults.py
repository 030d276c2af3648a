"""``BroadcastSim(mesh=)`` under faults and delays against the JAX
package's sharded BroadcastSim, on the reference's own mesh cases:

- the gather path's per-edge ``delays`` (tests/test_tpu_sim_broadcast.py
  ``test_delays_sharded_matches_single_device`` and ``..._large_
  partitioned_matches``), its fault plan (tests/test_nemesis.py
  ``test_broadcast_faulted_fused_matches_stepwise``), the composition of
  windows, delays, crash and loss (``test_partitions_delays_crash_loss_
  compose_on_gather_path``), ``union_block`` and the loss and crash server
  ledgers;
- the words-major delay bundles' halo closures: ``delayed``, under a
  window, and ``edge_delayed`` (tests/test_tpu_sim_broadcast.py
  ``test_delayed_structured_sharded_matches_single_device``,
  ``test_delayed_faulted_structured_sharded_matches``,
  ``test_edge_delayed_sharded_matches_single_device``), and random edge
  delays under a window (tests/test_nemesis.py ``test_edge_delays_compose_
  with_partitions_structured``);
- the structured nemesis on the halo path and the all-gather fallback,
  stepwise, fused and the donated fixed trip (tests/test_nemesis.py
  ``test_structured_nemesis_sharded_fused_donated_parity``, its 1-D mesh
  part), with ``dir_delays``, and its loss-only server ledger round by
  round (tests/test_ledger_calibration.py);
- each bundle's halo closures on one random block set, against the
  reference's inside ``shard_map``, and the refusals.

Rounds, received sets, ``msgs`` and ``srv_msgs`` are equal bit for bit
(tolerance 0), on 4 ranks and on 2, and equal to the port's one-process
run.  The port runs in one spawned world of 4 gloo ranks on the CPU
(``torch_mesh_fault_cases``; its 2-rank cases on a subgroup of ranks 0
and 1); the JAX package on ``pick_mesh(max_axis=P)`` of its virtual-device
test mesh."""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp
import torch_mesh_fault_cases as F
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import engine as je
from gossip_glomers_tpu.tpu_sim import faults as jfaults
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import structured as pst

WORLD_TIMEOUT = 240.0
FIELDS = ("rounds", "msgs", "srv")


@pytest.fixture(scope="module")
def world():
    ranks = dcn_worker.spawn_world(F.fault_world, 4, backend="gloo",
                                   device="cpu", timeout=WORLD_TIMEOUT)
    # every rank of a mesh took the same rounds and ledgers and read the
    # same gathered received sets
    for p, members in ((4, ranks), (2, ranks[:2])):
        for r in members[1:]:
            for part in ("gather", "delays", "nemesis"):
                for key, val in members[0][p].get(part, {}).items():
                    if key == "ledger":
                        continue
                    other = r[p][part][key]
                    assert {f: other[f] for f in FIELDS} \
                        == {f: val[f] for f in FIELDS}, (p, key)
                    np.testing.assert_array_equal(other["received"],
                                                  val["received"])
    out = {4: ranks[0][4], 2: ranks[0][2]}
    # each rank reports its own block of the bundle closures' outputs
    out["bundles"] = {4: [r[4]["bundles"] for r in ranks],
                      2: [r[2]["bundles"] for r in ranks[:2]]}
    return out


@pytest.fixture(scope="module")
def one():
    """The port's one-process runs of the same cases, on the CPU."""
    return {"gather": F.gather_cases(None),
            "delays": F.structured_delay_cases(None),
            "nemesis": F.nemesis_cases(None)}


def _jmesh(p: int):
    return jpick_mesh(max_axis=p)


def _jres(sim, state, rounds) -> dict:
    return {"rounds": int(rounds), "msgs": int(state.msgs),
            "received": np.asarray(sim.received_node_major(state)),
            "srv": None if state.srv_msgs is None else int(state.srv_msgs)}


def _same(mine: dict, want: dict, what) -> None:
    for f in FIELDS:
        assert mine[f] == want[f], (what, f, mine[f], want[f])
    np.testing.assert_array_equal(mine["received"], want["received"],
                                  err_msg=str(what))


def _one_key(key):
    """The one-process run's key of a mesh case (no shard count)."""
    if isinstance(key, tuple):
        return tuple(None if isinstance(x, int) and x in (2, 4) else x
                     for x in key)
    return key


def _check(mine: dict, one: dict, key, want: dict) -> None:
    _same(mine, want, key)
    _same(mine, one[_one_key(key)], ("one process", key))


def _jparts(group, start, end):
    return jbc.Partitions(jnp.array([start], jnp.int32),
                          jnp.array([end], jnp.int32), jnp.asarray(group))


def _jplan(kw):
    return jfaults.NemesisSpec(**kw).compile()


# -- the gather path -----------------------------------------------------------


def test_gather_delays_sharded_matches_single_device(world, one):
    nbrs, delays = F.gather_delays_inputs()
    inject = jbc.make_inject(64, 48)
    sim = jbc.BroadcastSim(nbrs, n_values=48, delays=delays, mesh=_jmesh(4))
    want = _jres(sim, *sim.run(inject))
    mine = world[4]["gather"]["delays"]
    _check(mine, one["gather"], "delays", want)
    # the ring is node-sharded: a rank holds its L x B x W block
    assert mine["ring"] == (3, 16, 2)
    assert mine["calls"]["ppermute"] == 0
    _check(world[4]["gather"]["delays_fused"], one["gather"],
           "delays_fused", _jres(sim, *sim.run_fused(inject)))


def test_gather_delays_large_partitioned_matches(world, one):
    nbrs, delays, group = F.gather_delays_parts_inputs()
    sim = jbc.BroadcastSim(nbrs, n_values=32, sync_every=6,
                           parts=_jparts(group, 2, 9), delays=delays,
                           mesh=_jmesh(4))
    want = _jres(sim, *sim.run_fused(jbc.make_inject(1024, 32)))
    _check(world[4]["gather"]["delays_parts"], one["gather"],
           "delays_parts", want)


def test_gather_plan_fused_and_fixed_match(world, one):
    from gossip_glomers_tpu.parallel.topology import (grid,
                                                      to_padded_neighbors)

    n, nv = 16, 24
    inject = jbc.make_inject(n, nv)
    sim = jbc.BroadcastSim(to_padded_neighbors(grid(n)), n_values=nv,
                           sync_every=4, fault_plan=_jplan(F.SPEC16),
                           parts=_jparts(F.quarter_groups(n), 3, 6),
                           srv_ledger=False, mesh=_jmesh(4))
    state, rounds = sim.run(inject, max_rounds=200)
    want = _jres(sim, state, rounds)
    g = world[4]["gather"]
    _check(g["plan"], one["gather"], "plan", want)
    _check(g["plan_fused"], one["gather"], "plan_fused", want)
    _check(g["plan_fixed"], one["gather"], "plan_fixed", want)
    # a round all-gathers the payload and, while the dup stream runs,
    # the dup rows: no ppermute
    calls = g["plan"]["calls"]
    assert calls["ppermute"] == 0
    assert rounds < calls["all_gather"] <= 2 * rounds + 1


def test_gather_partitions_delays_crash_loss_compose(world, one):
    from gossip_glomers_tpu.parallel.topology import (grid,
                                                      to_padded_neighbors)

    n, nv = 16, 24
    nbrs = to_padded_neighbors(grid(n))
    sim = jbc.BroadcastSim(nbrs, n_values=nv, sync_every=4,
                           fault_plan=_jplan(F.COMPOSE16),
                           parts=_jparts(F.quarter_groups(n), 3, 6),
                           delays=F.compose_delays(nbrs), mesh=_jmesh(4))
    want = _jres(sim, *sim.run(jbc.make_inject(n, nv), max_rounds=400))
    _check(world[4]["gather"]["compose"], one["gather"], "compose", want)


def test_gather_union_block_on_mesh_matches_materialized(world, one):
    from gossip_glomers_tpu.parallel.topology import (to_padded_neighbors,
                                                      tree)

    nbrs = to_padded_neighbors(tree(64))
    sim = jbc.BroadcastSim(nbrs, n_values=48, sync_every=4,
                           fault_plan=_jplan(F.NEM_SPEC), srv_ledger=False,
                           union_block="materialized")
    want = _jres(sim, *sim.run(jbc.make_inject(64, 48), max_rounds=200))
    for ub in (None, 4):
        mine = world[4]["gather"][("union_block", ub)]
        _check(mine, one["gather"], ("union_block", ub), want)
    # the block resolves against a rank's 16 rows
    assert world[4]["gather"][("union_block", 4)]["ub"] == 4


@pytest.mark.parametrize("name,spec", [("ledger_loss", F.LEDGER_SPEC),
                                       ("ledger_crash", dict(
                                           F.LEDGER_SPEC,
                                           crash=((2, 5, (3, 40)),)))])
def test_gather_plan_server_ledger_on_mesh(world, one, name, spec):
    from gossip_glomers_tpu.parallel.topology import (to_padded_neighbors,
                                                      tree)

    sim = jbc.BroadcastSim(to_padded_neighbors(tree(64)), n_values=48,
                           sync_every=4, fault_plan=_jplan(spec),
                           mesh=_jmesh(4))
    want = _jres(sim, *sim.run(jbc.make_inject(64, 48), max_rounds=200))
    assert want["srv"] is not None
    _check(world[4]["gather"][name], one["gather"], name, want)


# -- the words-major delay bundles -----------------------------------------------


@pytest.mark.parametrize("p", (4, 2))
def test_delayed_structured_sharded_matches(world, one, p):
    for topo, n, kw, dd in F.DELAYED_CASES:
        inject = jbc.make_inject(n, 48)
        dl = jst.make_delayed(topo, n, dd, n_shards=p, **kw)
        assert dl.sharded_exchange is not None
        sim = jbc.BroadcastSim(
            F.nbrs_of(topo, n, kw), n_values=48, sync_every=6,
            mesh=_jmesh(p), exchange=jst.make_exchange(topo, n, **kw),
            sync_diff=jst.make_sync_diff(topo, n, **kw),
            sharded_sync_diff=jst.make_sharded_sync_diff(topo, n, p, **kw),
            delayed=dl)
        want = _jres(sim, *sim.run(inject))
        mine = world[p]["delays"][("delayed", topo)]
        _check(mine, one["delays"], ("delayed", topo), want)
        assert mine["ring"] == (max(dd), 2, n // p)
        assert mine["calls"]["all_gather"] == 0, topo


@pytest.mark.parametrize("p", (4, 2))
def test_delayed_faulted_structured_sharded_matches(world, one, p):
    n, strides, dd = 128, [1, 5, 33], (1, 2, 3, 1, 2, 3)
    group = F.delayed_faulted_group()
    sim = jbc.BroadcastSim(
        F.nbrs_of("circulant", n, {"strides": strides}), n_values=48,
        sync_every=6, parts=_jparts(group, 2, 9), mesh=_jmesh(p),
        exchange=jst.make_exchange("circulant", n, strides=strides),
        delayed=jst.make_delayed_faulted("circulant", n, dd, group,
                                         n_shards=p, strides=strides))
    want = _jres(sim, *sim.run(jbc.make_inject(n, 48)))
    assert want["srv"] is not None
    _check(world[p]["delays"]["delayed_faulted"], one["delays"],
           "delayed_faulted", want)


@pytest.mark.parametrize("p", (4, 2))
def test_edge_delayed_sharded_matches(world, one, p):
    for (topo, n, kw, _), rows in zip(F.EDGE_CASES, F.edge_rows()):
        inject = jbc.make_inject(n, 48)
        sim = jbc.BroadcastSim(
            F.nbrs_of(topo, n, kw), n_values=48, sync_every=6,
            mesh=_jmesh(p), exchange=jst.make_exchange(topo, n, **kw),
            sync_diff=jst.make_sync_diff(topo, n, **kw),
            sharded_sync_diff=jst.make_sharded_sync_diff(topo, n, p, **kw),
            edge_delayed=jst.make_edge_delayed(topo, n, rows, n_shards=p,
                                               **kw))
        want = _jres(sim, *sim.run(inject))
        d = world[p]["delays"]
        _check(d[("edge", topo)], one["delays"], ("edge", topo), want)
        _check(d[("edge_fused", topo)], one["delays"], ("edge_fused", topo),
               want)
        _check(d[("edge_fixed", topo)], one["delays"], ("edge_fixed", topo),
               want)
        assert d[("edge", topo)]["ring"] == (3, 2, n // p)


@pytest.mark.parametrize("p", (4, 2))
def test_edge_delays_compose_with_partitions_on_mesh(world, one, p):
    for (topo, n, _, kw), rows in zip(F.EDGE_FAULTED_CASES,
                                      F.edge_faulted_rows()):
        groups = F.half_groups(n)
        sim = jbc.BroadcastSim(
            F.nbrs_of(topo, n, kw), n_values=48, sync_every=4,
            parts=_jparts(groups, 2, 9), mesh=_jmesh(p),
            exchange=jst.make_exchange(topo, n, **kw),
            edge_delayed=jst.make_edge_delayed_faulted(
                topo, n, rows, groups, n_shards=p, **kw))
        want = _jres(sim, *sim.run(jbc.make_inject(n, 48), max_rounds=400))
        assert want["srv"] is not None
        _check(world[p]["delays"][("edge_faulted", topo)], one["delays"],
               ("edge_faulted", topo), want)


# -- the structured nemesis ------------------------------------------------------


def _jnem_sim(p, topo, kw, shards, dd=None):
    n, nv = 64, 48
    groups = F.half_groups(n)
    nem = jst.make_nemesis(topo, n, jfaults.NemesisSpec(**F.NEM_SPEC),
                           groups=groups, dir_delays=dd, n_shards=shards,
                           **kw)
    return jbc.BroadcastSim(
        F.nbrs_of(topo, n, kw), n_values=nv, sync_every=4,
        parts=_jparts(groups, 2, 9), mesh=_jmesh(p),
        exchange=jst.make_exchange(topo, n, **kw),
        fault_plan=_jplan(F.NEM_SPEC), nemesis=nem, srv_ledger=False), nem


@pytest.mark.parametrize("p", (4, 2))
def test_structured_nemesis_sharded_fused_donated_parity(world, one, p):
    inject = jbc.make_inject(64, 48)
    for topo, kw in F.NEM_CASES:
        for shards in (p, None):     # the halo path, the fallback
            sim, nem = _jnem_sim(p, topo, kw, shards)
            want = _jres(sim, *sim.run(inject, max_rounds=200))
            nm = world[p]["nemesis"]
            mine = nm[("nem", topo, shards)]
            assert mine["halo"] == (nem.sharded_exchange is not None) \
                == (shards is not None), (topo, shards)
            _check(mine, one["nemesis"], ("nem", topo, shards), want)
            for run in ("nem_fused", "nem_fixed"):
                _check(nm[(run, topo, shards)], one["nemesis"],
                       (run, topo, shards), want)
            if shards is not None:
                # the halo path makes no all-gather
                assert mine["calls"]["all_gather"] == 0, topo
                assert mine["calls"]["ppermute"] > 0, topo


@pytest.mark.parametrize("p", (4, 2))
def test_structured_nemesis_dir_delays_on_mesh(world, one, p):
    inject = jbc.make_inject(64, 48)
    for topo, kw, dd in F.NEM_DELAYED_CASES:
        for shards in (p, None):
            sim, _ = _jnem_sim(p, topo, kw, shards, dd)
            want = _jres(sim, *sim.run(inject, max_rounds=400))
            _check(world[p]["nemesis"][("nem_delayed", topo, shards)],
                   one["nemesis"], ("nem_delayed", topo, shards), want)


@pytest.mark.parametrize("p", (4, 2))
def test_sharded_nemesis_server_ledger_round_by_round(world, one, p):
    from gossip_glomers_tpu.parallel.topology import (to_padded_neighbors,
                                                      tree)

    n = 64
    spec = jfaults.NemesisSpec(**F.LEDGER_SPEC)
    sim = jbc.BroadcastSim(
        to_padded_neighbors(tree(n)), n_values=48, sync_every=4,
        fault_plan=spec.compile(), mesh=_jmesh(p),
        exchange=jst.make_exchange("tree", n),
        sharded_exchange=jst.make_sharded_exchange("tree", n, p),
        nemesis=jst.make_nemesis("tree", n, spec, n_shards=p))
    state = sim.init_state(jbc.make_inject(n, 48))
    srv, msgs = [], []
    for _ in range(12):
        state = sim.step(state)
        srv.append(sim.server_msgs(state))
        msgs.append(int(state.msgs))
    mine = world[p]["nemesis"]["ledger"]
    assert mine["srv"] == srv == one["nemesis"]["ledger"]["srv"]
    assert mine["msgs"] == msgs == one["nemesis"]["ledger"]["msgs"]
    np.testing.assert_array_equal(mine["received"],
                                  np.asarray(sim.received_node_major(state)))


# -- the bundles' halo closures on one block set -----------------------------------


def _jrun(mesh, fn, in_specs, out_specs, *args):
    prog = je.jit_program(fn, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
    return jax.tree_util.tree_map(np.asarray, prog(*args))


@pytest.mark.parametrize("p", (4, 2))
def test_bundle_halo_closures_match_reference(world, p):
    mesh = _jmesh(p)
    row, ring = P(None, "nodes"), P(None, None, "nodes")
    for i, (topo, n, kw) in enumerate(F.BUNDLE_CASES):
        blocks = [b[(topo, n)] for b in world["bundles"][p]]

        def stitch(key, j=None):
            return np.concatenate([b[key] if j is None else b[key][j]
                                   for b in blocks], axis=-1)

        nem = jst.make_nemesis(topo, n, jfaults.NemesisSpec(
            n_nodes=n, seed=3, loss_rate=0.3, loss_until=5), n_shards=p,
            **kw)
        d = int(nem.arrs.exists.shape[0])
        x = F.bundle_inputs(i, n, d)

        def nem_body(ps, lv, pc):
            ex = nem.sharded_exchange(lambda _d: ps, lv)
            return (ex,) + tuple(nem.sharded_src_pc(j, pc)
                                 for j in range(d))

        got = _jrun(mesh, nem_body, (row, row, row), (row,) * (1 + d),
                    jnp.asarray(x["p"]), jnp.asarray(x["live"]),
                    jnp.asarray(x["counts"].astype(np.uint32)))
        np.testing.assert_array_equal(stitch("nem_exchange"), got[0],
                                      err_msg=f"nemesis {topo} {n}")
        for j in range(d):
            np.testing.assert_array_equal(
                stitch("nem_src_pc", j).astype(np.uint32), got[1 + j],
                err_msg=f"src_pc {topo} {n} {j}")
        for b in blocks:     # the halo closures make no all-gather
            assert b["nem_calls"]["all_gather"] == 0
            assert b["nem_calls"]["all_reduce"] == 0
        dcls = pst._n_classes(topo, n, **kw)
        dd = tuple(1 + (j % 3) for j in range(dcls))
        dl = jst.make_delayed(topo, n, dd, n_shards=p, **kw)
        rows = np.random.default_rng(200 + i).integers(
            1, 4, (dcls, n)).astype(np.int32)
        ed = jst.make_edge_delayed(topo, n, rows, n_shards=p, **kw)
        for j, t in enumerate((0, 1, 5)):
            got = _jrun(mesh, lambda h, t=t: dl.sharded_exchange(
                h, jnp.int32(t)), (ring,), row, jnp.asarray(x["hist"]))
            np.testing.assert_array_equal(stitch("delayed", j), got,
                                          err_msg=f"delayed {topo} {t}")
        for j, t in enumerate((0, 2, 5)):
            got = _jrun(mesh, lambda h, r, t=t: ed.sharded_exchange(
                h, jnp.int32(t), r), (ring, row), row,
                jnp.asarray(x["hist"]), jnp.asarray(rows))
            np.testing.assert_array_equal(stitch("edge", j), got,
                                          err_msg=f"edge {topo} {t}")


def test_halo_less_delay_bundles_refused_on_mesh(world):
    from gossip_glomers_tpu.parallel.topology import (to_padded_neighbors,
                                                      tree)

    n = 64
    nbrs = to_padded_neighbors(tree(n))
    kw = dict(n_values=8, mesh=_jmesh(4),
              exchange=jst.make_exchange("tree", n))
    for name, extra in (
            ("delayed", dict(delayed=jst.make_delayed("tree", n, (1, 2)))),
            ("edge_delayed", dict(edge_delayed=jst.make_edge_delayed(
                "tree", n, np.ones((2, n), np.int32))))):
        with pytest.raises(ValueError) as want:
            jbc.BroadcastSim(nbrs, **kw, **extra)
        assert world[4]["refusals"][name] == ("ValueError",
                                              str(want.value)), name


GATE_CASES = [("tree", 24, 4, {}), ("tree", 64, 4, {}), ("tree", 64, 8, {}),
              ("grid", 64, 8, {}), ("grid", 256, 4, {}), ("line", 8, 8, {}),
              ("line", 64, 4, {}), ("ring", 12, 8, {}),
              ("circulant", 64, 4, {"strides": [1, 5]}),
              ("tree", 32, 2, {"branching": 8})]


@pytest.mark.parametrize("topo,n,shards,kw", GATE_CASES,
                         ids=[f"{t}-{n}-{s}" for t, n, s, _ in GATE_CASES])
def test_bundle_halo_gates_match_reference(topo, n, shards, kw):
    """Every bundle's halo closures exist exactly where the reference's
    do (make_sharded_exchange's shape gates), and are None there."""
    dcls = pst._n_classes(topo, n, **kw)
    dd = (1,) * dcls
    rows = np.ones((dcls, n), np.int32)
    groups = np.zeros((1, n), np.int8)
    spec_kw = dict(n_nodes=n, seed=1, loss_rate=0.1, loss_until=3)
    from gossip_glomers_tpu_torch.tpu_sim import faults as pfaults

    pairs = [
        (jst.make_nemesis(topo, n, jfaults.NemesisSpec(**spec_kw),
                          n_shards=shards, **kw).sharded_exchange,
         pst.make_nemesis(topo, n, pfaults.NemesisSpec(**spec_kw),
                          n_shards=shards, device="cpu",
                          **kw).sharded_exchange),
        (jst.make_delayed(topo, n, dd, n_shards=shards,
                          **kw).sharded_exchange,
         pst.make_delayed(topo, n, dd, n_shards=shards,
                          **kw).sharded_exchange),
        (jst.make_delayed_faulted(topo, n, dd, groups, n_shards=shards,
                                  **kw).sharded_exchange,
         pst.make_delayed_faulted(topo, n, dd, groups, n_shards=shards,
                                  **kw).sharded_exchange),
        (jst.make_edge_delayed(topo, n, rows, n_shards=shards,
                               **kw).sharded_exchange,
         pst.make_edge_delayed(topo, n, rows, n_shards=shards,
                               **kw).sharded_exchange),
        (jst.make_edge_delayed_faulted(topo, n, rows, groups,
                                       n_shards=shards,
                                       **kw).sharded_sync_diff,
         pst.make_edge_delayed_faulted(topo, n, rows, groups,
                                       n_shards=shards,
                                       **kw).sharded_sync_diff)]
    for j, (want, got) in enumerate(pairs):
        assert (got is None) == (want is None), (j, topo, n, shards)
