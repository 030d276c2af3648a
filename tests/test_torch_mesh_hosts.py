"""The hierarchical ``("hosts", "nodes")`` mesh and ``dcn_mode``: the port
on ``pick_mesh_2d(hosts=2)`` of a 4-rank gloo world
(``torch_mesh_hosts_cases.hosts_world``), synchronous and pipelined,
against the flat 4-rank mesh (itself held against the JAX package by the
other mesh files), the 3-host case on ranks 0-2 against the flat 3-rank
mesh (tests/test_dcn_pr20.py:240-331), the engine's collectives member
by member, and under ``stale:k`` against a numpy model of the outbox
round by round; the stale counter campaign held to the reference tests'
own assertions (tests/test_dcn_pr20.py:334-400, which cannot run in the
JAX package: its stale ``reduce_sum`` fails at the ``lax.cond``), the
refusal matrix, and the worker's hosts task set against the JAX
package's ``run_tasks`` on its ``pick_mesh_2d(hosts=2)`` (``stale``: the
synchronous half, the only one the reference runs).

The world runs once for the module; the JAX references once."""

import numpy as np
import pytest

import torch_mesh_hosts_cases as C
from gossip_glomers_tpu_torch.harness.checkers import check_staleness_bound
from gossip_glomers_tpu_torch.parallel import dcn_worker

WORLD_TIMEOUT = 300.0
MODES = ("sync", "pipelined")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    bundles = str(tmp_path_factory.mktemp("stale_bundles"))
    ranks = dcn_worker.spawn_world(C.hosts_world, 4, backend="gloo",
                                   device="cpu", args=(bundles,),
                                   timeout=WORLD_TIMEOUT)
    # every rank holds the same replicated results
    for r in ranks[1:]:
        for key in ("stale", "refusals", "tasks"):
            assert _eq(r[key], ranks[0][key]), key
        for mesh in ("flat", "hosts_sync", "hosts_pipe"):
            assert _eq(r[mesh]["sims"], ranks[0][mesh]["sims"]), mesh
            assert _eq(r[mesh]["runners"], ranks[0][mesh]["runners"]), mesh
    return ranks


def _eq(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _key(mode: str) -> str:
    return "hosts_sync" if mode == "sync" else "hosts_pipe"


@pytest.fixture(scope="module")
def jax_tasks():
    from gossip_glomers_tpu.harness.nemesis import run_counter_nemesis
    from gossip_glomers_tpu.parallel import dcn_worker as jdw
    from gossip_glomers_tpu.parallel.mesh import pick_mesh_2d
    from gossip_glomers_tpu.tpu_sim.faults import NemesisSpec

    mesh = pick_mesh_2d(hosts=2)
    out = jdw.run_tasks(["batch", "certify", "takeover", "pipelined"], mesh)
    out["stale_sync"] = run_counter_nemesis(
        NemesisSpec(**C.STALE_SPEC), mode="allreduce", mesh=mesh,
        max_recovery_rounds=32, dcn_mode="sync")
    return out


def test_hosts_mesh_shape_and_node_axis(world):
    for rank, r in enumerate(world):
        assert r["shape"] == {"hosts": 2, "nodes": 2}
        assert r["coords"] == {"hosts": rank // 2, "nodes": rank % 2}
        assert r["node_axis"] == ["hosts", "nodes"]
        assert r["node_axes"] == ("hosts", "nodes")
        # hosts-major: a node shard's index is its rank in the world
        assert (r["node_index"], r["node_shards"]) == (rank, 4)
        # None on an uneven split and a cap below the hosts; a cap of 2
        # keeps the hosts and shrinks each host's axis (ranks 1 and 3
        # are outside that mesh)
        assert r["picks"]["uneven"] is None
        assert r["picks"]["cap_below"] is None
        assert r["picks"]["cap_2"] == (
            {"hosts": 2, "nodes": 1} if rank % 2 == 0 else None)


@pytest.mark.parametrize("mode", MODES)
def test_sims_on_the_hosts_mesh_equal_the_flat_mesh(world, mode):
    r = world[0]
    assert _eq(r[_key(mode)]["sims"], r["flat"]["sims"])


def test_pipelined_splits_the_hosts_level(world):
    # sync: one fused all-reduce over the composite node axis; pipelined:
    # the intra-host sum over nodes, then the per-host partial over hosts
    # as two half-block all-reduces (one for a one-element operand); the
    # fused ones left are the float sums and the convergence votes
    sync = world[0]["hosts_sync"]["calls"]
    pipe = world[0]["hosts_pipe"]["calls"]
    assert "all_reduce@hosts" not in sync
    assert pipe["all_reduce@nodes"] > 100
    assert pipe["all_reduce@hosts"] > pipe["all_reduce@nodes"]
    assert (pipe["all_reduce@hosts,nodes"]
            < sync["all_reduce@hosts,nodes"] // 10)
    assert world[0]["flat"]["calls"].keys() <= {
        "all_reduce@nodes", "all_gather@nodes", "ppermute@nodes"}


@pytest.mark.parametrize("mode", MODES)
def test_collectives_on_the_hosts_mesh_equal_the_flat_mesh(world, mode):
    for r in world:
        got, want = r[_key(mode)]["coll"], r["flat"]["coll"]
        for member in ("row_ids", "sum", "sum_i64", "sum_f32", "sum_bool",
                       "max", "min", "or", "and", "excl", "widen",
                       "scalar"):
            np.testing.assert_array_equal(got[member], want[member],
                                          err_msg=member)
        assert got["axis_name"] == ("hosts", "nodes")
    calls = world[0][_key(mode)]["coll"]["calls"]
    # the OR ladder runs within a host (nodes) then across (hosts),
    # pipelined as two half-blocks in flight a step
    assert calls["ppermute@nodes"] == 3
    assert calls["ppermute@hosts"] == (3 if mode == "sync" else 6)


@pytest.mark.parametrize("mode", MODES)
def test_runners_on_the_hosts_mesh_equal_the_flat_mesh(world, mode):
    r = world[0]
    got, want = r[_key(mode)]["runners"], r["flat"]["runners"]
    for name in want:
        assert _eq(got[name], want[name]), name
    assert want["broadcast"]["ok"] and want["kafka"]["ok"]
    assert want["batch"]["n_scenarios"] == 8


def test_three_hosts_pipelined_equals_sync_and_flat(world):
    three = world[0]["three"]
    assert world[3]["three"] is None        # rank 3 is no member
    assert _eq(three["h3_pipe"]["sims"], three["h3_sync"]["sims"])
    assert _eq(three["h3_pipe"]["sims"], three["flat"]["sims"])
    for r in world[:3]:
        t = r["three"]
        for member in ("sum", "sum_i64", "max", "min", "or", "and",
                       "excl", "widen"):
            np.testing.assert_array_equal(t["h3_pipe"]["coll"][member],
                                          t["flat"]["coll"][member])
            np.testing.assert_array_equal(t["h3_sync"]["coll"][member],
                                          t["flat"]["coll"][member])
    # three hosts: the OR ladder's ring fallback (two steps) on hosts
    assert three["h3_sync"]["coll"]["calls"]["ppermute@hosts"] == 6
    assert three["h3_pipe"]["coll"]["calls"]["ppermute@hosts"] == 12


def _model(rank: int, t: int, k: int):
    """The outbox model of :func:`torch_mesh_hosts_cases.stale_rounds`
    (rank ``rank``, round ``t``): ``reduce_sum`` delivers the backlog
    of every rank's operands since the last refresh on refresh rounds
    (``t % k == 0``) and zeros between them; ``reduce_or`` unions the
    backlog over every rank on refresh rounds and the host's current
    operands between them; ``reduce_and`` is the global meet on refresh
    rounds and the host's current meet with the last refresh's
    between."""
    ranks, host = range(4), [2 * (rank // 2), 2 * (rank // 2) + 1]
    last = t - t % k
    start = 0 if last == 0 else last - k + 1
    if t % k == 0:
        s = sum(C.operand(q, u).astype(np.int64) for q in ranks
                for u in range(start, t + 1)).astype(np.int32)
        o = np.bitwise_or.reduce([C.bits_operand(q, u) for q in ranks
                                  for u in range(start, t + 1)])
        a = np.bitwise_and.reduce([C.bits_operand(q, t) for q in ranks])
        return s, o, a
    s = np.zeros_like(C.operand(rank, t))
    o = np.bitwise_or.reduce([C.bits_operand(q, t) for q in host])
    snap = np.bitwise_and.reduce([C.bits_operand(q, last) for q in ranks])
    a = np.bitwise_and.reduce([C.bits_operand(q, t) for q in host]) & snap
    return s, o, a


def test_stale_collectives_equal_the_outbox_model(world):
    k = C.STALE_K
    for rank, r in enumerate(world):
        for t, got in enumerate(r["stale_coll"]["rounds"]):
            s, o, a = _model(rank, t, k)
            np.testing.assert_array_equal(got["sum"], s, err_msg=str(t))
            np.testing.assert_array_equal(got["or"], o, err_msg=str(t))
            np.testing.assert_array_equal(got["and"], a, err_msg=str(t))
    calls = world[0]["stale_coll"]["calls"]
    # only a refresh round crosses the hosts level
    for t, c in enumerate(calls):
        crosses = any(a.startswith(("all_reduce@hosts", "ppermute@hosts"))
                      for a in c)
        assert crosses == (t % k == 0), (t, c)
    ref = world[0]["stale_coll"]["refusals"]
    for member in ("reduce_max", "reduce_min", "widen", "exclusive_sum"):
        assert "no certified staleness semantics" in ref[member]
    assert "floating operand" in ref["float_sum"]


def test_stale_counter_bounded_delay_zero_loss(world):
    runs = world[0]["stale"]
    for label in ("sync", "stale"):
        assert runs[label]["ok"], runs[label]
        assert runs[label]["n_lost_writes"] == 0
        assert runs[label]["kv"] == runs[label]["acked_sum"]
    delay = (runs["stale"]["converged_round"]
             - runs["sync"]["converged_round"])
    # the deferred-delivery carry is real (delay >= 1) and bounded
    assert 1 <= delay <= 4, runs
    ok, d = check_staleness_bound(
        stale_k=4, sync_converged_round=runs["sync"]["converged_round"],
        stale_converged_round=runs["stale"]["converged_round"],
        lost_writes=[],
        recovery=(runs["stale"]["ok"],
                  {"converged_round": runs["stale"]["converged_round"]}))
    assert ok, d
    # the planted violation: the same rounds against k = 1 fail, naming
    # the round
    ok, d = check_staleness_bound(
        stale_k=1, sync_converged_round=runs["sync"]["converged_round"],
        stale_converged_round=runs["stale"]["converged_round"],
        lost_writes=[])
    assert not ok
    assert d["violating_round"] == runs["stale"]["converged_round"]
    # the outbox: a lag round keeps its flushed deltas (drained from
    # pending, not yet in the KV), the refresh round delivers them
    box = runs["outbox"]
    assert box == {"kv_after_lag": 136, "pending": 0, "backlog": 32,
                   "kv_after_refresh": 168}


def test_stale_flight_bundle_replays_mode(world):
    runs = world[0]["stale"]
    assert not runs["bad"]["ok"]
    assert runs["bundle"]["dcn_mode"] == "stale:4"
    assert runs["replay"] == {"ok": runs["bad"]["ok"],
                              "converged_round":
                                  runs["bad"]["converged_round"]}
    # the synchronous twin passes the same one-round budget: the
    # bundle's failure is the lag itself
    assert runs["sync_1"]["ok"], runs["sync_1"]


def test_stale_refusal_matrix(world):
    ref = world[0]["refusals"]
    assert "kafka has no" in ref["kafka"]
    assert "txn has no" in ref["txn"]
    assert "broadcast has no" in ref["broadcast"]
    assert "allreduce" in ref["counter_cas"]
    assert "host" in ref["counter_device"]
    assert "hierarchical" in ref["counter_flat"]
    assert ref["counter_stale"] == "ran"
    assert "observed drivers" in ref["counter_observed"]
    assert "traffic driver" in ref["counter_traffic"]
    assert "scenario batch" in ref["scenario"]
    assert "DcnRound" in ref["bare_mode"]
    assert "hierarchical" in ref["flat_mode"]
    assert "dcn=" in ref["string_dcn"]
    assert "refuses" in ref["dcn_psum"]


@pytest.mark.parametrize("task", ["batch", "certify", "takeover",
                                  "pipelined"])
def test_worker_tasks_equal_the_reference(world, jax_tasks, task):
    got = world[0]["tasks"]["hosts"][task]
    assert _eq(got, jax_tasks[task]), task
    # and the flat mesh's
    assert _eq(world[0]["tasks"]["flat"][task], got)


def test_worker_stale_task(world, jax_tasks):
    got = world[0]["tasks"]["hosts"]["stale"]
    want = jax_tasks["stale_sync"]
    # the synchronous half equals the reference's
    assert got["sync_round"] == want["converged_round"]
    assert got["acked_sum"] == int(want["acked_sum"])
    assert got["kv"] == int(want["kv"])
    assert got["ok"] and 1 <= got["delay_rounds"] <= 4
    assert got["bound_round"] == got["sync_round"] + 4
