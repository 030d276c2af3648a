"""Port parity for the g-counter: gossip_glomers_tpu_torch's ``CounterSim``
(both flush modes, both CAS winner layouts, ``kv_sched`` windows, a
``FaultPlan`` with amnesia and KV loss, materialized and swept in
``union_block`` slabs, the device KV backend with ``kv_amnesia`` and
stale coins, ``poll_every=0``, int32 wrap) against the JAX reference's on
the CPU, round by round, and its two round kernels' plain versions.

Deltas and specs come from seeded numpy and go to both packages;
``pending``, ``cached``, ``kv``, ``t``, ``msgs`` and the KV ``rows``
compare exactly (tolerance 0).  The JAX sims are built with
``mesh=None``.
"""

import collections

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.tpu_sim import counter as jc
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu_torch.tpu_sim import counter as pc
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import kvstore as pkv


def _port_plan(jplan):
    return pf.plan_from_numpy(**{k: np.asarray(v)
                                 for k, v in jplan._asdict().items()})


def _sims(n, spec=None, sched=None, **kw):
    """(JAX, port) CounterSims of the same arguments; ``spec`` a
    NemesisSpec's kwargs, ``sched`` (starts, ends, blocked) numpy."""
    jkw, pkw = dict(kw), dict(kw)
    if spec is not None:
        jplan = jf.NemesisSpec(**spec).compile()
        jkw["fault_plan"] = jplan
        pkw["fault_plan"] = _port_plan(jplan)
    if sched is not None:
        import jax.numpy as jnp

        starts, ends, blocked = sched
        jkw["kv_sched"] = jc.KVReach(jnp.asarray(starts, jnp.int32),
                                     jnp.asarray(ends, jnp.int32),
                                     jnp.asarray(blocked))
        pkw["kv_sched"] = pc.KVReach.from_numpy(starts, ends, blocked)
    return (jc.CounterSim(n, mesh=None, **jkw),
            pc.CounterSim(n, device="cpu", **pkw))


def _same(js, ps, where=""):
    np.testing.assert_array_equal(ps.pending.numpy(), np.asarray(js.pending),
                                  err_msg=f"pending {where}")
    np.testing.assert_array_equal(ps.cached.numpy(), np.asarray(js.cached),
                                  err_msg=f"cached {where}")
    assert int(ps.kv) == int(js.kv), where
    assert ps.t == int(js.t), where
    assert int(ps.msgs) == int(js.msgs), where
    assert (ps.rows is None) == (js.rows is None)
    if js.rows is not None:
        np.testing.assert_array_equal(ps.rows.vals.numpy(),
                                      np.asarray(js.rows.vals))
        np.testing.assert_array_equal(ps.rows.vers.numpy(),
                                      np.asarray(js.rows.vers))


def _drive(jsim, psim, deltas, rounds, adds=()):
    """Both sims round by round (extra ``adds``: {round: deltas}), equal
    after every round; then the port's run and run_fused land the same
    final state.  Returns the port's final state."""
    js = jsim.add(jsim.init_state(), deltas)
    ps = psim.add(psim.init_state(), deltas)
    for r in range(rounds):
        if r in dict(adds):
            js = jsim.add(js, dict(adds)[r])
            ps = psim.add(ps, dict(adds)[r])
        js, ps = jsim.step(js), psim.step(ps)
        _same(js, ps, f"round {r}")
    if not adds:
        _same(js, psim.run(psim.add(psim.init_state(), deltas), rounds))
        _same(js, psim.run_fused(psim.add(psim.init_state(), deltas),
                                 rounds))
    return ps


LAYOUTS = [("cas", "packed"), ("cas", "wide"), ("allreduce", "auto")]


@pytest.mark.parametrize("poll_every", (2, 3, 0))
@pytest.mark.parametrize("n", (8, 37))
@pytest.mark.parametrize("mode,key", LAYOUTS, ids=[f"{m}-{k}"
                                                    for m, k in LAYOUTS])
def test_counter_matches_reference(mode, key, n, poll_every):
    deltas = np.random.default_rng(n).integers(0, 6, n).astype(np.int32)
    jsim, psim = _sims(n, mode=mode, winner_key=key, poll_every=poll_every,
                       seed=n + poll_every)
    assert psim._wide == jsim._wide == (key == "wide")
    ps = _drive(jsim, psim, deltas, n + 4,
                adds=() if poll_every != 3 else ((5, deltas[::-1].copy()),))
    if poll_every == 2:
        # everything drains, and every node reads the sum
        assert psim.kv_value(ps) == int(deltas.sum())
        assert (psim.reads(ps) == int(deltas.sum())).all()


def test_counter_semantics_match_reference_tests():
    # the reference's cas-drain, one-round allreduce and blocked-half
    # cases (tests/test_tpu_sim_programs.py)
    n = 8
    for mode, rounds in (("cas", 12), ("allreduce", 4)):
        sim = pc.CounterSim(n, mode=mode, poll_every=2, device="cpu")
        st = sim.run(sim.add(sim.init_state(), np.arange(1, n + 1)), rounds)
        assert sim.kv_value(st) == 36 and (sim.reads(st) == 36).all()
    blocked = np.zeros((1, n), bool)
    blocked[0, :4] = True
    jsim, psim = _sims(n, sched=([0], [10], blocked), mode="cas",
                       poll_every=2)
    ps = _drive(jsim, psim, np.ones(n, np.int32), 8)
    assert psim.kv_value(ps) == 4
    ps = psim.run(ps, 20)
    assert psim.kv_value(ps) == 8 and (psim.reads(ps) == 8).all()


@pytest.mark.parametrize("mode", ("cas", "allreduce"))
def test_kv_sched_windows_match_reference(mode):
    # overlapping windows, one of them starting late
    n = 24
    rng = np.random.default_rng(3)
    blocked = rng.random((3, n)) < 0.4
    sched = ([0, 2, 9], [5, 11, 14], blocked)
    jsim, psim = _sims(n, sched=sched, mode=mode, poll_every=2, seed=5)
    _drive(jsim, psim, rng.integers(0, 9, n).astype(np.int32), 18)


PLAN = dict(n_nodes=16, seed=9, crash=((2, 6, (1, 8)),), loss_rate=0.2,
            loss_until=12)


@pytest.mark.parametrize("union_block", ("materialized", 4, 1, None))
@pytest.mark.parametrize("mode", ("cas", "allreduce"))
def test_fault_plan_matches_reference(mode, union_block):
    # tests/test_nemesis.py's counter plan: amnesia rows, down nodes and
    # the KV loss coin, the allreduce gate swept slab by slab or not
    n = 16
    jsim, psim = _sims(n, spec=PLAN, mode=mode, poll_every=2,
                       union_block=union_block)
    assert (psim._ub is None) == (jsim._ub is None)
    _drive(jsim, psim, np.arange(1, n + 1, dtype=np.int32), 24)


def test_membership_plan_matches_reference():
    # a join wipes the joining row's state and a leave takes a node down
    # for good
    n = 12
    spec = dict(n_nodes=n, seed=1, crash=((1, 4, (2, 3)),),
                join=((3, (5,)),), leave=((6, (7,)),), loss_rate=0.1,
                loss_until=8)
    jsim, psim = _sims(n, spec=spec, mode="cas", poll_every=2, seed=2)
    _drive(jsim, psim, np.arange(1, n + 1, dtype=np.int32), 20,
           adds=((4, np.full(n, 3, np.int32)),))


@pytest.mark.parametrize("mode", ("cas", "allreduce"))
def test_nemesis_runner_plan_matches_reference(mode):
    # the plan harness/nemesis.py's run_counter_nemesis builds for
    # benchmarks/fault_sweep.py's large-N row (random_spec, crash
    # windows shifted 4 rounds), driven through CounterSim directly
    n = 256
    spec = jf.random_spec(n, seed=1, horizon=12, n_crash_windows=2,
                          loss_rate=0.1)
    meta = spec.to_meta()
    meta["crash"] = [[s + 4, e + 4, ns] for s, e, ns in meta["crash"]]
    meta["loss_until"] += 4
    spec = jf.NemesisSpec.from_meta(meta)
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    jplan = spec.compile()
    jsim = jc.CounterSim(n, mode=mode, poll_every=2, fault_plan=jplan,
                         mesh=None)
    psim = pc.CounterSim(n, mode=mode, poll_every=2,
                         fault_plan=_port_plan(jplan), device="cpu")
    ps = _drive(jsim, psim, deltas, spec.clear_round + 8)
    if mode == "allreduce":
        assert int(ps.pending.sum()) == 0


@pytest.mark.parametrize("kv_amnesia", (False, True))
@pytest.mark.parametrize("mode", ("cas", "allreduce"))
def test_device_kv_backend_matches_reference(mode, kv_amnesia):
    # tests/test_kvstore.py's device-backend cases: the key's row is
    # read and CASed every round; with kv_amnesia its owner's crash wipes
    # it
    n = 8
    owner = int(pkv.host_owner_of(np.array([0]), n, 7)[0])
    spec = dict(n_nodes=n, seed=4, crash=((1, 3, (2, owner)),),
                loss_rate=0.2, loss_until=5)
    jsim, psim = _sims(n, spec=spec, mode=mode, seed=7, poll_every=2,
                       kv_backend="device", kv_amnesia=kv_amnesia)
    ps = _drive(jsim, psim, np.arange(1, n + 1, dtype=np.int32), 12)
    lay = psim._kv_layout
    assert int(ps.rows.vals[int(lay.owner[0]), int(lay.slot[0])]) \
        == int(ps.kv)
    # run keeps the rows passed in; run_fused writes the donated rows
    # in place (a wipe, under kv_amnesia, gives new ones)
    st0 = psim.add(psim.init_state(), np.ones(n, np.int32))
    psim.run(st0, 4)
    assert not st0.rows.vals.any() and not st0.rows.vers.any()
    fused = psim.run_fused(st0, 2)
    assert kv_amnesia or fused.rows.vals is st0.rows.vals


@pytest.mark.parametrize("stale", ((0.3, 8, None), (0.9, 20, 5)))
def test_stale_coins_match_reference(stale):
    prob, until, sseed = stale
    n = 16
    spec = dict(n_nodes=n, seed=4, crash=((1, 3, (2,)),), loss_rate=0.2,
                loss_until=5)
    jsim, psim = _sims(n, spec=spec, mode="cas", seed=7, poll_every=2,
                       kv_backend="device", stale_prob=prob,
                       stale_until=until, stale_seed=sseed)
    _drive(jsim, psim, np.arange(1, n + 1, dtype=np.int32), 24)


@pytest.mark.parametrize("mode", ("cas", "allreduce"))
def test_int32_wrap_matches_reference(mode):
    # pending near 2^31 on several nodes: the KV value wraps as int32
    n = 9
    deltas = np.full(n, 2**31 - 5, np.int32)
    deltas[::3] = 3
    jsim, psim = _sims(n, mode=mode, poll_every=2, seed=1)
    ps = _drive(jsim, psim, deltas, 14)
    want = int(deltas.astype(np.int64).sum())
    assert psim.kv_value(ps) == (want + 2**31) % 2**32 - 2**31


def test_packed_and_wide_agree_on_the_sum():
    # at one n the two layouts pick other winners each round (other
    # priorities) but each equals its reference and both drain the sum
    n = 40
    deltas = np.random.default_rng(1).integers(1, 9, n).astype(np.int32)
    finals = []
    for key in ("packed", "wide"):
        jsim, psim = _sims(n, mode="cas", poll_every=2, winner_key=key,
                           seed=11)
        finals.append(_drive(jsim, psim, deltas, n + 2))
    assert [int(s.kv) for s in finals] == [int(deltas.sum())] * 2
    assert all((s.pending == 0).all() for s in finals)


@pytest.mark.parametrize("key", ("packed", "wide"))
def test_winner_ties_match_reference(key):
    # 2^14 rows all fresh: with 17 priority bits (packed) ties are
    # common, and the lowest row among the least priority wins
    n = 1 << 14
    jsim, psim = _sims(n, mode="cas", poll_every=4, winner_key=key, seed=3)
    js = jsim.add(jsim.init_state(), np.ones(n, np.int32))
    ps = psim.add(psim.init_state(), np.ones(n, np.int32))
    for r in range(3):
        js, ps = jsim.step(js), psim.step(ps)
        _same(js, ps, f"round {r}")


def test_winner_distribution_matches_reference():
    # the first-round winner, as the reference's uniformity test draws
    # it: equal to the reference's seed by seed, and over 400 seeds
    # every node wins roughly as often (no lowest-index bias)
    n, trials = 8, 400
    wins = collections.Counter()
    for seed in range(trials):
        for key in ("packed", "wide"):
            if seed < 12:
                jsim, psim = _sims(n, mode="cas", poll_every=0, seed=seed,
                                   winner_key=key)
            else:
                psim = pc.CounterSim(n, mode="cas", poll_every=0,
                                     seed=seed, winner_key=key,
                                     device="cpu")
            ps = psim.step(psim.add(psim.init_state(), np.ones(n, np.int32)))
            if seed < 12:
                js = jsim.step(jsim.add(jsim.init_state(),
                                        np.ones(n, np.int32)))
                _same(js, ps, f"seed {seed}")
            (winner,) = np.nonzero(ps.pending.numpy() == 0)[0]
            wins[(key, int(winner))] += 1
    assert len(wins) == 2 * n
    assert all(0.4 * trials / n <= c <= 1.9 * trials / n
               for c in wins.values()), dict(wins)


def test_counter_bench_partitioned_small():
    # benchmarks/run_all.py's _counter_bench at 2^10 nodes: half the
    # nodes cut off the KV for rounds [0, 8) of 16, allreduce
    n = 1 << 10
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    blocked = np.zeros((1, n), bool)
    blocked[0, : n // 2] = True
    jsim, psim = _sims(n, sched=([0], [8], blocked), mode="allreduce",
                       poll_every=2)
    ps = _drive(jsim, psim, deltas, 16)
    assert psim.kv_value(ps) == int(deltas.sum())
    assert (psim.reads(ps) == int(deltas.sum())).all()


def test_reach_matches_reference():
    import jax.numpy as jnp

    n = 20
    blocked = np.random.default_rng(2).random((2, n)) < 0.5
    jsched = jc.KVReach(jnp.array([1, 3], jnp.int32),
                        jnp.array([4, 6], jnp.int32), jnp.asarray(blocked))
    psched = pc.KVReach.from_numpy([1, 3], [4, 6], blocked)
    ids = np.arange(n, dtype=np.int32)
    for t in range(8):
        np.testing.assert_array_equal(
            pc._reach(t, torch.from_numpy(ids), psched).numpy(),
            np.asarray(jc._reach(jnp.int32(t), jnp.asarray(ids), jsched)))


def test_round_kernels_plain_versions_edges():
    # n = 1 and n = 0, no contender, and the gate's wipe and blocked bits
    for n in (0, 1, 5):
        pend = torch.arange(n, dtype=torch.int32)
        cach = torch.zeros(n, dtype=torch.int32)
        work = kernels.counter_work("cpu")
        kv0 = torch.zeros((), dtype=torch.int32)
        msgs = torch.tensor(2**32 - 2, dtype=torch.int64)
        gate = torch.tensor([3, 1, 0, 2, 0][:n], dtype=torch.uint8)
        kv, m = kernels.counter_select(pend, cach, gate, kv0, msgs, work,
                                       cas=True, wide=False, row_bits=3,
                                       t=0, seed=0, poll=True)
        # rows 0 and 3 wiped, 0 and 1 blocked: rows 2 and 4 contend,
        # rows 2, 3 and 4 are polled
        want = [i for i in (2, 4) if i < n]
        assert int(work[3]) in (want or [n])
        assert int(kv) == (int(work[3]) if want else 0)
        assert int(m) == (2**32 - 2 + 4 * len(want)
                          + 2 * (max(n - 2, 0) - bool(want))) % 2**32
        p2, c2 = kernels.counter_apply(pend, cach, gate, kv, work, cas=True,
                                       poll=True)
        assert p2.shape == (n,) and c2.shape == (n,)
        assert [int(w) for w in work[:3]] == [-1, 0, 0]


def test_round_kernel_checks():
    pend = torch.zeros(4, dtype=torch.int32)
    work = kernels.counter_work("cpu")
    kv0 = torch.zeros((), dtype=torch.int32)
    msgs = torch.zeros((), dtype=torch.int64)
    kw = dict(cas=True, wide=False, row_bits=2, t=0, seed=0, poll=False)
    with pytest.raises(ValueError, match="int32"):
        kernels.counter_select(pend.long(), pend, None, kv0, msgs, work,
                               **kw)
    with pytest.raises(ValueError, match="gate"):
        kernels.counter_select(pend, pend, pend.bool(), kv0, msgs, work,
                               **kw)
    with pytest.raises(ValueError, match="work"):
        kernels.counter_select(pend, pend, None, kv0, msgs, work[:3], **kw)
    with pytest.raises(ValueError, match="msgs"):
        kernels.counter_select(pend, pend, None, kv0, msgs.int(), work,
                               **kw)
    with pytest.raises(ValueError, match="row bits"):
        kernels.counter_select(pend, pend, None, kv0, msgs, work,
                               **dict(kw, row_bits=24))
    with pytest.raises(ValueError, match="out"):
        kernels.counter_apply(pend, pend, None, kv0, work, cas=True,
                              poll=False, out=(pend, pend[:2]))


def test_counter_errors_match_reference():
    # a mesh is the port's parallel.mesh.Mesh
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        pc.CounterSim(8, mesh=object(), device="cpu")
    # dcn_mode runs: off a mesh the hosts level is absent, so every mode
    # but a stale one equals the reference's run in it, round by round
    for mode, dcn in (("cas", "pipelined"), ("allreduce", "sync")):
        jsim, psim = _sims(8, mode=mode, seed=7, dcn_mode=dcn)
        _drive(jsim, psim, np.arange(1, 9, dtype=np.int32), 10)
    # a stale mode needs a hierarchical mesh, as in the reference
    for kw in (dict(mesh=None), dict(mesh=None, mode="allreduce")):
        with pytest.raises(ValueError) as got:
            pc.CounterSim(8, dcn_mode="stale:2", device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jc.CounterSim(8, dcn_mode="stale:2", **kw)
        assert ("hierarchical" in str(got.value)) == (
            "hierarchical" in str(want.value))
    sim = pc.CounterSim(8, device="cpu")
    for name, item in (("audit_run_program", 14),
                       ("audit_traffic_program", 14),
                       ("audit_observed_program", 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            getattr(sim, name)
    # the open-loop traffic driver, its telemetry ring and the observed
    # driver with its provenance record are ported
    for name in ("run_traffic", "traffic_state", "telemetry_state",
                 "run_observed", "provenance_state"):
        assert callable(getattr(sim, name))
    # the scenario batches' round hook runs: one round in place
    st, tel = pc._build_batch_round(sim)(sim.init_state())
    assert st.t == 1 and tel is None and bool(pc._batch_converged(st))
    for kw in (dict(mode="x"), dict(winner_key="x"), dict(kv_backend="x"),
               dict(kv_amnesia=True), dict(stale_prob=0.1),
               dict(mode="allreduce", kv_backend="device", stale_prob=0.1),
               dict(winner_key="packed", n=1 << 24),
               dict(n=1 << 31)):
        n = kw.pop("n", 8)
        for mod, extra in ((jc, {"mesh": None}), (pc, {"device": "cpu"})):
            with pytest.raises(ValueError):
                mod.CounterSim(n, **kw, **extra)
    dup = dict(n_nodes=4, seed=0, dup_rate=0.2, dup_until=4)
    with pytest.raises(ValueError, match="dup"):
        pc.CounterSim(4, kv_backend="device", device="cpu",
                      fault_plan=pf.NemesisSpec(**dup).compile("cpu"))
    pc.CounterSim(4, device="cpu",
                  fault_plan=pf.NemesisSpec(**dup).compile("cpu"))
    with pytest.raises(ValueError, match="FaultPlan"):
        pc.CounterSim(5, device="cpu",
                      fault_plan=pf.NemesisSpec(n_nodes=4).compile("cpu"))
    assert pc.CounterSim(1 << 25, device="cpu")._wide
    assert not pc.CounterSim(1 << 10, device="cpu")._wide


def test_counter_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.CounterSim(8)
