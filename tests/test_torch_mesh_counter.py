"""``CounterSim(mesh=)`` against the JAX package's sharded CounterSim, on
the reference's own mesh cases: tests/test_tpu_sim_programs.py
``test_counter_sharded_matches_single_device``, tests/test_engine.py
``test_counter_run_fused_matches_stepwise`` (its mesh case) and
``test_counter_sharded_run_fused_matches_single_device``,
tests/test_kvstore.py ``test_counter_device_backend_bit_exact_on_8way_
mesh`` (round by round), tests/test_nemesis.py ``test_counter_faulted_
fused_matches_stepwise_and_mesh`` and ``test_counter_blocked_fault_gate_
matches_materialized`` (its mesh case), both flush modes and both winner
keys under a plan and a KV window, ``kv_amnesia`` with the stale coins,
and the ``sims`` task's counter digests against the reference's.

Pending, cached reads, ``kv``, ``t``, ``msgs`` and the device KV's rows
are equal bit for bit, on 4 ranks and on 2, and equal to the port's
one-process run; a round makes all-reduces only.  The port runs in one
spawned world of 4 gloo ranks on the CPU (``torch_mesh_fault_cases``, its
2-rank cases on a subgroup of ranks 0 and 1); the JAX package on
``pick_mesh(max_axis=P)`` of its virtual-device test mesh.  The read
pass's partial form (``kernels.counter_select(partial=True)``) is held
against the one-device read pass here too."""

import numpy as np
import pytest
import torch

import torch_mesh_fault_cases as F
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.tpu_sim import counter as jc
from gossip_glomers_tpu.tpu_sim import faults as jfaults
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import kernels

WORLD_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def world():
    ranks = dcn_worker.spawn_world(F.counter_world, 4, backend="gloo",
                                   device="cpu", timeout=WORLD_TIMEOUT)
    for p, members in ((4, ranks), (2, ranks[:2])):
        for r in members[1:]:
            for key, val in members[0][p].items():
                vals = val if isinstance(val, list) else [val]
                others = r[p][key] if isinstance(val, list) else [r[p][key]]
                for a, b in zip(vals, others):
                    for f in ("kv", "t", "msgs"):
                        assert a[f] == b[f], (p, key, f)
                    np.testing.assert_array_equal(a["cached"], b["cached"])
    assert all(r["sims"] == ranks[0]["sims"] for r in ranks)
    return {4: ranks[0][4], 2: ranks[0][2], "sims": ranks[0]["sims"]}


@pytest.fixture(scope="module")
def one():
    return F.counter_cases(None)


def _jmesh(p):
    return jpick_mesh(max_axis=p)


def _jstate(sim, st) -> dict:
    return {"pending": np.asarray(st.pending), "cached": sim.reads(st),
            "kv": int(st.kv), "t": int(st.t), "msgs": int(st.msgs)}


def _same(mine: dict, want: dict, what) -> None:
    for f in ("kv", "t", "msgs"):
        assert mine[f] == want[f], (what, f, mine[f], want[f])
    for f in ("pending", "cached"):
        np.testing.assert_array_equal(mine[f], want[f], err_msg=f"{what} {f}")


def _check(mine, one, want, what) -> None:
    _same(mine, want, what)
    _same(mine, one, ("one process", what))


def _jplan(kw):
    return jfaults.NemesisSpec(**kw).compile()


@pytest.mark.parametrize("p", (4, 2))
def test_counter_sharded_matches_reference(world, one, p):
    mesh = _jmesh(p)
    sim = jc.CounterSim(64, mode="cas", poll_every=2, mesh=mesh)
    st = sim.run(sim.add(sim.init_state(), F.counter_deltas(64, 0)), 60)
    _check(world[p]["programs"], one["programs"], _jstate(sim, st),
           "programs")
    assert world[p]["programs"]["kv"] == int(F.counter_deltas(64, 0).sum())
    st = sim.run_fused(sim.add(sim.init_state(), F.counter_deltas(64, 7)),
                       20)
    _check(world[p]["sharded_fused"], one["sharded_fused"],
           _jstate(sim, st), "sharded_fused")


@pytest.mark.parametrize("p", (4, 2))
def test_counter_run_fused_matches_stepwise_on_mesh(world, one, p):
    sim = jc.CounterSim(16, mode="cas", poll_every=2, seed=3,
                        mesh=_jmesh(p))
    st = sim.add(sim.init_state(), F.counter_deltas(16))
    for _ in range(12):
        st = sim.step(st)
    want = _jstate(sim, st)
    for name in ("engine_step", "engine_run", "engine_fused"):
        _check(world[p][name], one[name], want, name)


@pytest.mark.parametrize("p", (4, 2))
@pytest.mark.parametrize("mode,key", [("cas", "packed"), ("cas", "wide"),
                                      ("allreduce", "packed"),
                                      ("allreduce", "wide")])
def test_counter_plan_and_window_on_mesh(world, one, p, mode, key):
    blocked = np.zeros((1, 16), bool)
    blocked[0, :4] = True
    import jax.numpy as jnp

    sched = jc.KVReach(jnp.array([3], jnp.int32), jnp.array([9], jnp.int32),
                       jnp.asarray(blocked))
    # the JAX package's sharded round cannot take a KV window (its
    # _reach fold trips shard_map's varying-axes check): the one-device
    # reference it equals off a mesh is the oracle here
    sim = jc.CounterSim(16, mode=mode, poll_every=2, winner_key=key,
                        fault_plan=_jplan(F.COUNTER_SPEC), kv_sched=sched)
    st = sim.run_fused(sim.add(sim.init_state(), F.counter_deltas(16)), 24)
    mine = world[p][("plan", mode, key)]
    _check(mine, one[("plan", mode, key)], _jstate(sim, st), (mode, key))
    # all-reduces only: the winner's minimum and the sums (cas), the sums
    # (allreduce), and the convergence-free fused trip reads nothing
    calls = mine["calls"]
    assert calls["ppermute"] == 0 and calls["all_gather"] == 0
    assert calls["all_reduce"] == 24 * (2 if mode == "cas" else 1)


@pytest.mark.parametrize("p", (4, 2))
def test_counter_blocked_fault_gate_on_mesh(world, one, p):
    sim = jc.CounterSim(16, mode="allreduce", poll_every=2,
                        fault_plan=_jplan(F.COUNTER_SPEC),
                        union_block="materialized", mesh=_jmesh(p))
    st = sim.run_fused(sim.add(sim.init_state(), F.counter_deltas(16)), 20)
    want = _jstate(sim, st)
    for ub in ("materialized", 2):
        _check(world[p][("blocked", ub)], one[("blocked", ub)], want, ub)


@pytest.mark.parametrize("p", (4, 2))
def test_counter_device_kv_round_by_round_on_mesh(world, one, p):
    sim = jc.CounterSim(16, mode="cas", poll_every=2, seed=3,
                        fault_plan=_jplan(F.KV_SPEC), kv_backend="device",
                        mesh=_jmesh(p))
    st = sim.add(sim.init_state(), F.counter_deltas(16))
    for t, (mine, o) in enumerate(zip(world[p]["device_kv"],
                                      one["device_kv"])):
        st = sim.step(st)
        _check(mine, o, _jstate(sim, st), t)
        np.testing.assert_array_equal(mine["vals"],
                                      np.asarray(st.rows.vals))
        np.testing.assert_array_equal(mine["vals"], o["vals"])
        # the view's all-reduce, the winner's minimum, the sums
        assert mine["calls"] == {"ppermute": 0, "all_gather": 0,
                                 "all_reduce": 3}, t


@pytest.mark.parametrize("p", (4, 2))
def test_counter_kv_amnesia_and_stale_coins_on_mesh(world, one, p):
    sim = jc.CounterSim(16, mode="cas", poll_every=2, seed=7,
                        fault_plan=jfaults.NemesisSpec(
                            n_nodes=16, seed=2, crash=((1, 3, (4, 11)),),
                            loss_rate=0.1, loss_until=8).compile(),
                        kv_backend="device", kv_amnesia=True,
                        stale_prob=0.4, stale_until=12, union_block=4,
                        mesh=_jmesh(p))
    st = sim.run(sim.add(sim.init_state(), F.counter_deltas(16)), 24)
    _check(world[p]["amnesia_stale"], one["amnesia_stale"],
           _jstate(sim, st), "amnesia_stale")


def test_sims_task_counter_digests_equal_reference(world):
    from gossip_glomers_tpu.parallel import dcn_worker as jdw

    want = jdw._task_sims(_jmesh(4))["counter"]
    assert world["sims"]["counter"] == want
    assert dcn_worker._task_sims(None, "cpu", ("counter",)) == world["sims"]


# -- the read pass's partial form ----------------------------------------------


def _finish(parts, kv0, msgs, cas, poll, n):
    """The mesh's reduction and finish of the ranks' partials (the
    counter's), on the host."""
    no_key = (1 << 63) - 1
    if cas:
        best = min(int(p[0]) for p in parts)
        delta = sum(int(p[1]) for p in parts if int(p[0]) == best)
        inc = sum(int(p[2]) for p in parts)
        has = best != no_key
        kv = (kv0 + delta) if has else kv0
        msgs = (msgs + inc - (2 if has and poll else 0)) & 0xFFFFFFFF
        winner = (best & 0xFFFFFFFF) if has else n
    else:
        kv = kv0 + sum(int(p[1]) for p in parts)
        msgs = (msgs + sum(int(p[2]) for p in parts)) & 0xFFFFFFFF
        winner = n
    kv = ((kv + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return kv, msgs, winner


@pytest.mark.parametrize("cas,wide", [(True, False), (True, True),
                                      (False, False)])
@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("seed", range(4))
def test_counter_select_partial_equals_one_device(cas, wide, shards, seed):
    """The partial read pass over each block and the mesh's finish equal
    the one-device read pass on random inputs: kv, msgs and the winner,
    the wide key's ties broken by the lowest row across blocks."""
    rng = np.random.default_rng(seed)
    n = 64
    pending = torch.from_numpy(rng.integers(-3, 6, n).astype(np.int32))
    kv0 = torch.tensor(int(rng.integers(0, 4)), dtype=torch.int32)
    cached = torch.from_numpy(rng.choice([int(kv0), int(kv0) + 1], n)
                              .astype(np.int32))
    gate = torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8))
    msgs = torch.tensor(int(rng.integers(0, 1 << 32)), dtype=torch.int64)
    kw = dict(cas=cas, wide=wide, row_bits=6, t=int(rng.integers(0, 50)),
              seed=seed, poll=bool(seed % 2))
    work = kernels.counter_work("cpu")
    kv, m = kernels.counter_select(pending, cached, gate, kv0, msgs, work,
                                   **kw)
    b = n // shards
    parts = [kernels.counter_select(
        pending[r * b:(r + 1) * b].contiguous(),
        cached[r * b:(r + 1) * b].contiguous(),
        gate[r * b:(r + 1) * b].contiguous(), kv0, msgs,
        kernels.counter_work("cpu"), row0=r * b, partial=True, **kw)
        for r in range(shards)]
    got = _finish(parts, int(kv0), int(msgs), cas, kw["poll"], n)
    assert got == (int(kv), int(m), int(work[3] if cas else n))
    # the update pass over each block, given the winner, equals the
    # one-device update
    full = kernels.counter_apply(pending, cached, gate, kv, work, cas=cas,
                                 poll=kw["poll"], stale_num=1 << 31,
                                 stale_seed=5, t=kw["t"])
    wk = kernels.counter_work("cpu")
    wk[3] = got[2]
    for r in range(shards):
        sl = slice(r * b, (r + 1) * b)
        blk = kernels.counter_apply(
            pending[sl].contiguous(), cached[sl].contiguous(),
            gate[sl].contiguous(), kv, wk, cas=cas, poll=kw["poll"],
            stale_num=1 << 31, stale_seed=5, t=kw["t"], row0=r * b)
        for x, y in zip(blk, full):
            assert torch.equal(x, y[sl])


def test_counter_select_partial_form_checks_rows():
    z = torch.zeros(4, dtype=torch.int32)
    args = (z, z, None, torch.zeros((), dtype=torch.int32),
            torch.zeros((), dtype=torch.int64), kernels.counter_work("cpu"))
    kw = dict(cas=True, wide=False, row_bits=3, t=0, seed=0, poll=False)
    with pytest.raises(ValueError, match="row0"):
        kernels.counter_select(*args, row0=4, **kw)
    with pytest.raises(ValueError, match="2\\^31"):
        kernels.counter_select(*args, row0=(1 << 31) - 2, partial=True,
                               **kw)
