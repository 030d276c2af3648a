"""``BroadcastSim`` on a ``("nodes", "words")`` mesh: the port on a 2 x 2
gloo world (``torch_mesh_2d_cases.words_world``) against the JAX
package's 8-device ``(4, 2)`` ``("nodes", "words")`` mesh (the reference's
``mesh_2d`` cases, tests/test_tpu_sim_broadcast.py, and the nemesis
bundle on it, tests/test_nemesis.py) and against the port's one-process
run: rounds, every node's received set, ``msgs`` and the server ledger,
bit for bit, in both layouts (the node-major gather path, the words-major
halo path and its all-gather fallback), under partitions and the
nemesis, through ``run``, ``run_fused``, ``stage`` / ``run_staged`` /
``run_staged_fixed`` (the flood specialization on the halo path),
``read`` and ``received_node_major``.  Also ``inject_mid`` on the mesh,
the 1-D words mesh of ``pick_mesh(axis_name="words")``, the collectives
the words mesh makes by axis, and what a words mesh refuses (the other
sims, provenance, the traffic drivers).

The world runs once for the module; the JAX references once each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import torch_mesh_2d_cases as C
from gossip_glomers_tpu.parallel.topology import (
    grid as jgrid, to_padded_neighbors as jpad, tree as jtree)
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.parallel import dcn_worker

WORLD_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def world():
    ranks = dcn_worker.spawn_world(C.words_world, 4, backend="gloo",
                                   device="cpu", timeout=WORLD_TIMEOUT)
    # every rank read the same gathered results
    for r in ranks[1:]:
        for name, case in r["cases"].items():
            for drv, got in case.items():
                want = ranks[0]["cases"][name][drv]
                if isinstance(got, dict):
                    np.testing.assert_array_equal(got["received"],
                                                  want["received"])
                    assert {k: v for k, v in got.items()
                            if k != "received"} == {
                        k: v for k, v in want.items() if k != "received"}
                else:
                    assert got == want, (name, drv)
    return ranks


@pytest.fixture(scope="module")
def one_process():
    return C.one_process_words()


def _jmesh():
    return JMesh(np.array(jax.devices()[:8]).reshape(4, 2),
                 ("nodes", "words"))


def _jsim(name: str):
    """The JAX package's sim of a case on its (4, 2) words mesh."""
    topo, n, nv, se, how = C.WORD_CASES[name]
    nbrs = jpad(jtree(n) if topo == "tree" else jgrid(n))
    mesh = _jmesh()
    kw = dict(n_values=nv, sync_every=se, mesh=mesh)
    groups = C.half_groups(n)
    parts = jbc.Partitions(jnp.array([1], jnp.int32),
                           jnp.array([6], jnp.int32), jnp.asarray(groups))
    spec = jf.NemesisSpec(n_nodes=n, **C.NEM_SPEC)
    if how.startswith("gather"):
        if how == "gather_parts":
            kw["parts"] = parts
        if how == "gather_plan":
            kw.update(fault_plan=spec.compile(), srv_ledger=False)
        return jbc.BroadcastSim(nbrs, **kw)
    kw["exchange"] = jst.make_exchange(topo, n)
    if how in ("halo", "halo_flood"):
        kw["sharded_exchange"] = jst.make_sharded_exchange(topo, n, 4)
        kw["sharded_sync_diff"] = jst.make_sharded_sync_diff(topo, n, 4)
    if how in ("halo_flood", "fallback"):
        kw["srv_ledger"] = False
    if how == "faulted":
        kw.update(parts=parts,
                  faulted=jst.make_faulted(topo, n, groups, n_shards=4))
    if how == "nemesis":
        kw.update(parts=parts, fault_plan=spec.compile(),
                  nemesis=jst.make_nemesis(topo, n, spec, groups=groups,
                                           n_shards=4),
                  srv_ledger=False)
    return jbc.BroadcastSim(nbrs, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, (_, n, nv, _, how) in C.WORD_CASES.items():
        sim = _jsim(name)
        inject = jbc.make_inject(n, nv)
        if how in ("gather_fused", "halo_flood"):
            state, rounds = sim.run_fused(inject)
        else:
            state, rounds = sim.run(inject)
        out[name] = {
            "rounds": int(rounds),
            "received": np.asarray(sim.received_node_major(state)),
            "msgs": int(state.msgs),
            "srv": (None if state.srv_msgs is None
                    else int(state.srv_msgs)),
            "read0": sim.read(state)[0]}
    return out


def _same(got: dict, want: dict, what) -> None:
    assert got["rounds"] == want["rounds"], what
    np.testing.assert_array_equal(got["received"], want["received"],
                                  err_msg=str(what))
    assert got["msgs"] == want["msgs"], what
    assert got["srv"] == want["srv"], what


def test_words_mesh_shape_and_axes(world):
    coords = sorted((r["coords"]["nodes"], r["coords"]["words"])
                    for r in world)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in world:
        assert r["shape"] == {"nodes": 2, "words": 2}
        assert r["node_axis"] == ["nodes"]
        # the halo exchanges and the gathers ride the nodes axis, the
        # ledgers' sums both axes, the readout's last gather the words
        assert set(r["axes_used"]) == {
            "ppermute@nodes", "all_gather@nodes", "all_gather@words",
            "all_reduce@nodes,words"}


@pytest.mark.parametrize("name", sorted(C.WORD_CASES))
def test_words_mesh_equals_reference_and_one_process(world, one_process,
                                                     jax_runs, name):
    got = world[0]["cases"][name]
    want = jax_runs[name]
    _same(got["run"], want, (name, "jax"))
    _same(got["run"], one_process["cases"][name]["run"], (name, "one"))
    assert got["read0"] == want["read0"]
    for drv in ("staged", "fixed"):
        if drv in got:
            _same(got[drv], one_process["cases"][name][drv], (name, drv))
            np.testing.assert_array_equal(got[drv]["received"],
                                          want["received"])
    if "flood_path" in got:
        # the pure-flood specialization engages on the halo path with
        # the ledger off, as on one process
        assert got["flood_path"] == one_process["cases"][name][
            "flood_path"]
        assert got["flood_path"] == (name == "wm_tree_flood")


def test_shard_put_cuts_both_axes(world):
    whole = np.arange(16 * 4, dtype=np.int32).reshape(16, 4)
    for r in world:
        n, w = r["coords"]["nodes"], r["coords"]["words"]
        np.testing.assert_array_equal(
            r["shard_put"], whole[8 * n:8 * (n + 1), 2 * w:2 * (w + 1)])


def test_inject_mid_on_a_words_mesh(world, one_process):
    for r in world:
        _same(r["inject_mid"], one_process["inject_mid"], "inject_mid")


def test_one_d_words_mesh_equals_one_process(world):
    import torch_mesh_2d_cases as cases
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, structured

    n, nv = 64, 128
    for r in world:
        one_d = r["one_d"]
        assert one_d["shape"] == {"words": 4}
        assert one_d["node_axis"] == ["nodes"]
        for name, kw in (("gather", {}),
                         ("wm", {"exchange": structured.make_exchange(
                             "tree", n), "srv_ledger": False})):
            sim = broadcast.BroadcastSim(cases.nbrs_of("tree", n),
                                         n_values=nv, sync_every=4,
                                         device="cpu", **kw)
            state, rounds = sim.run(broadcast.make_inject(n, nv))
            _same(one_d[name], cases._res(sim, state, rounds), name)


def test_words_mesh_refusals(world):
    for r in world:
        ref = r["refusals"]
        for sim in ("counter", "kafka", "txn", "ids", "echo"):
            assert "node axis only" in ref[sim], (sim, ref[sim])
        assert "1-D node meshes" in ref["provenance"]
        assert "traffic drivers run on node meshes" in ref["traffic"]
