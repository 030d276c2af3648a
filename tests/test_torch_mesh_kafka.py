"""``KafkaSim(mesh=)``, ``UniqueIdsSim(mesh=)`` and ``EchoSim(mesh=)``
against the JAX package's sharded sims, on the reference's own mesh
cases: tests/test_engine.py ``test_kafka_repl_fast_path_matches_matmul``,
``test_kafka_run_fused_matches_run_rounds``, ``test_kafka_sharded_fast_
path_matches_single_device`` and ``test_kafka_faulted_union_matches_
matmul_oracle``; tests/test_nemesis.py ``test_kafka_faulted_scan_matches_
stepwise_and_mesh`` (round by round) and ``test_kafka_blocked_union_three_
way_parity``; tests/test_kvstore.py ``test_kafka_device_backend_bit_exact_
on_8way_mesh``; tests/test_tpu_sim_programs.py's sharded Kafka, ids, echo,
``kv_sched`` and commit-free cases; and the push resync, ``kv_amnesia``
(round by round) and the host reads on every rank.

Every field (``log_vals``, ``present``, ``kv_val``, ``local_committed``,
``origin_bits``, ``t``, ``msgs``, the device KV's rows) is equal bit for
bit on 4 ranks and on 2, and equal to the port's one-process run.  The
port runs in one spawned world of 4 gloo ranks on the CPU
(``torch_mesh_kafka_cases``, its 2-rank cases on a subgroup of ranks 0
and 1); the JAX package on ``pick_mesh(max_axis=P)`` of its virtual-
device test mesh.  The collective census by kind is the port's own (it
packs operands, so its all-reduce and ppermute counts are not XLA's):
no all-gather in ``union`` and the blocked ``union_nem``, one (the packed
metadata widen) a round in the materialized ``union_nem``, one (the own
words) a round in ``matmul``.

The block forms of the Kafka kernels' plain versions (``row0``,
``origin0``, ``accumulate``, ``n_total``, ``partial``) are held here too:
a seeded problem split into 2 and 4 blocks, the blocks combined as the
mesh combines them, equals the whole problem and the reference's
expressions; dropping ``row0`` or taking a block's own sentinel does
not."""

import itertools

import numpy as np
import pytest
import torch

import torch_mesh_kafka_cases as K
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.tpu_sim import counter as jc
from gossip_glomers_tpu.tpu_sim import echo as je
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim import kafka as jk
from gossip_glomers_tpu.tpu_sim import unique_ids as ju
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import kernels

WORLD_TIMEOUT = 180.0
FIELDS = ("log_vals", "present", "kv_val", "local_committed", "origin_bits")


def _agree(a, b, path=()):
    """Two ranks' results equal (the collective calls aside)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            if key != "calls":
                _agree(a[key], b[key], path + (key,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _agree(x, y, path + (i,))
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def world():
    ranks = dcn_worker.spawn_world(K.kafka_world, 4, backend="gloo",
                                   device="cpu", timeout=WORLD_TIMEOUT)
    for p, members in ((4, ranks), (2, ranks[:2])):
        for r in members[1:]:
            _agree(members[0][p], r[p], (p,))
    assert all(r["sims"] == ranks[0]["sims"] for r in ranks)
    return {4: ranks[0][4], 2: ranks[0][2], "sims": ranks[0]["sims"]}


@pytest.fixture(scope="module")
def one():
    return K.kafka_cases(None)


def _jmesh(p):
    return jpick_mesh(max_axis=p)


def _jplan(kw):
    return jf.NemesisSpec(**kw).compile()


def _jstate(st) -> dict:
    out = {f: np.asarray(getattr(st, f)) for f in FIELDS}
    out.update(t=int(st.t), msgs=int(st.msgs))
    if st.rows is not None:
        out.update(rows_vals=np.asarray(st.rows.vals),
                   rows_vers=np.asarray(st.rows.vers))
    return out


def _same(mine: dict, want: dict, what) -> None:
    assert set(k for k in mine if k not in ("calls", "ub")) == set(want), \
        what
    for f, v in want.items():
        if isinstance(v, np.ndarray):
            assert mine[f].shape == v.shape, (what, f)
            np.testing.assert_array_equal(mine[f], v, err_msg=f"{what} {f}")
        else:
            assert mine[f] == v, (what, f, mine[f], v)


def _check(mine, one, want, what) -> None:
    _same(mine, want, what)
    _same(mine, {k: v for k, v in one.items()
                 if k not in ("calls", "ub")}, ("one process", what))


def _jstep(sim, b, per_round=False):
    sks, svs, crs = b
    st, rounds = sim.init_state(), []
    for i in range(sks.shape[0]):
        st = sim.step(st, sks[i], svs[i], None if crs is None else crs[i])
        rounds.append(_jstate(st))
    return rounds if per_round else rounds[-1]


# -- the reference's mesh cases ------------------------------------------------


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_repl_fast_path_matches_matmul_on_mesh(world, one, p):
    b = K.batches(8, 5, 2, 6, seed=11)
    for name, kw in (("fast", {}), ("slow", dict(repl_fast=False))):
        sim = jk.KafkaSim(8, 5, capacity=64, max_sends=2, mesh=_jmesh(p),
                          **kw)
        want = _jstate(sim.run_rounds(sim.init_state(), *b))
        for drv in ("rounds", "step"):
            key = ("fast_matmul", name, drv)
            _check(world[p][key], one[key], want, key)
        _same(world[p][("fast_matmul", name, "step")], _jstep(sim, b), name)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_run_fused_matches_run_rounds_on_mesh(world, one, p):
    b = K.batches(8, 5, 2, 5, seed=13)
    sim = jk.KafkaSim(8, 5, capacity=64, max_sends=2, mesh=_jmesh(p))
    want = _jstate(sim.run_rounds(sim.init_state(), *b))
    for drv in ("rounds", "fused"):
        _check(world[p][("fused", drv)], one[("fused", drv)], want, drv)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_sharded_fast_path_matches_single_device(world, one, p):
    b = K.batches(8, 5, 2, 6, seed=17)
    ref = jk.KafkaSim(8, 5, capacity=64, max_sends=2)
    want = _jstate(ref.run_rounds(ref.init_state(), *b))
    shd = jk.KafkaSim(8, 5, capacity=64, max_sends=2, mesh=_jmesh(p))
    _same(_jstate(shd.run_rounds(shd.init_state(), *b)), want, "jax")
    _check(world[p]["sharded_union"], one["sharded_union"], want, "union")


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_faulted_union_matches_matmul_oracle_on_mesh(world, one, p):
    b = K.staged(K.NEM8, 12, 4, 2)
    for name, kw in (("fast", {}), ("slow", dict(repl_fast=False))):
        sim = jk.KafkaSim(8, 4, capacity=64, max_sends=2, mesh=_jmesh(p),
                          fault_plan=_jplan(K.NEM8), **kw)
        want = _jstate(sim.run_rounds(sim.init_state(), *b))
        for drv in ("rounds", "step"):
            key = ("faulted_oracle", name, drv)
            _check(world[p][key], one[key], want, key)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_faulted_scan_matches_stepwise_round_by_round(world, one, p):
    b = K.staged(K.SCAN8, 12, 4, 2)
    sim = jk.KafkaSim(8, 4, capacity=64, max_sends=2, mesh=_jmesh(p),
                      fault_plan=_jplan(K.SCAN8))
    assert sim._repl_mode(None) == "union_nem"
    rounds = _jstep(sim, b, per_round=True)
    mine = world[p][("faulted_scan", "step")]
    for t, (got, o, want) in enumerate(zip(mine, one[("faulted_scan",
                                                      "step")], rounds)):
        _check(got, o, want, ("round", t))
    for drv in ("fused", "rounds"):
        _check(world[p][("faulted_scan", drv)], one[("faulted_scan", drv)],
               rounds[-1], drv)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_blocked_union_three_way_parity_on_mesh(world, one, p):
    b = K.staged(K.NEM16, 10, 4, 2)
    sim = jk.KafkaSim(16, 4, capacity=64, max_sends=2, mesh=_jmesh(p),
                      fault_plan=_jplan(K.NEM16), union_block="materialized")
    want = _jstate(sim.run_fused(sim.init_state(), *b))
    for name in K.THREE_WAY:
        for drv in ("fused", "step"):
            key = ("three_way", name, drv)
            _check(world[p][key], one[key], want, key)
    assert world[p][("three_way", "blocked", "fused")]["ub"] == 1
    assert world[p][("three_way", "materialized", "fused")]["ub"] is None


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_three_way_census_on_mesh(world, p):
    """The collectives a round, by kind, over the 10 fused rounds (two of
    them resync rounds): the allocation's prefix scan (log2 P ppermutes)
    and, on a resync round, the union's OR circuit (log2 P more); the
    append's sum, the winners' minimum and the commit sum (3
    all-reduces); then the replication's own: the blocked ring's P - 1
    ppermutes, the materialized form's one metadata widen, the matmul's
    one own-words gather."""
    lg, rounds, resyncs = {4: 2, 2: 1}[p], 10, 2
    base = rounds * lg + resyncs * lg
    want = {"blocked": {"ppermute": base + rounds * (p - 1),
                        "all_gather": 0, "all_reduce": 3 * rounds},
            "materialized": {"ppermute": base, "all_gather": rounds,
                             "all_reduce": 3 * rounds},
            "matmul": {"ppermute": base, "all_gather": rounds,
                       "all_reduce": 3 * rounds}}
    for name, calls in want.items():
        assert world[p][("three_way", name, "fused")]["calls"] == calls, name


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_union_census_on_mesh(world, p):
    """The fault-free union (the reference's sharded-step-union contract:
    all-reduces and ppermutes, no all-gather): a round's prefix scan and
    OR circuit (2 log2 P ppermutes) and the append's sum; with commits
    the winners' minimum and the commit sum as well."""
    lg = {4: 2, 2: 1}[p]
    assert world[p][("commit_free", "auto")]["calls"] == {
        "ppermute": 4 * 2 * lg, "all_gather": 0, "all_reduce": 4}
    assert world[p][("fast_matmul", "fast", "rounds")]["calls"] == {
        "ppermute": 6 * 2 * lg, "all_gather": 0, "all_reduce": 6 * 3}
    assert world[p][("fast_matmul", "slow", "rounds")]["calls"] == {
        "ppermute": 6 * lg, "all_gather": 6, "all_reduce": 6 * 3}


@pytest.mark.parametrize("p", (4, 2))
@pytest.mark.parametrize("ub", (1, "materialized"))
def test_kafka_push_resync_on_mesh(world, one, p, ub):
    b = K.staged(K.NEM16, 10, 4, 2)
    sim = jk.KafkaSim(16, 4, capacity=64, max_sends=2, mesh=_jmesh(p),
                      fault_plan=_jplan(K.NEM16), resync_mode="push",
                      union_block=ub)
    want = _jstate(sim.run_fused(sim.init_state(), *b))
    assert want["origin_bits"].shape == (16, 4, 2)
    _check(world[p][("push", ub)], one[("push", ub)], want, ("push", ub))
    gathers = world[p][("push", ub)]["calls"]["all_gather"]
    assert gathers == (0 if ub == 1 else 10)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_device_backend_bit_exact_on_mesh(world, one, p):
    single = jk.KafkaSim(8, 2, capacity=32, max_sends=1,
                         kv_backend="device")
    sharded = jk.KafkaSim(8, 2, capacity=32, max_sends=1,
                          kv_backend="device", mesh=_jmesh(p))
    want = K.drive_kafka(single)
    assert K.drive_kafka(sharded) == want
    for backend in ("host", "device"):
        got = world[p][("drive_kafka", backend)]
        assert got == want == one[("drive_kafka", backend)], backend


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_kv_amnesia_on_mesh_round_by_round(world, one, p):
    b = K.staged(K.AMNESIA16, 10, 8, 2)
    sim = jk.KafkaSim(16, 8, capacity=64, max_sends=2, mesh=_jmesh(p),
                      fault_plan=_jplan(K.AMNESIA16), kv_backend="device",
                      kv_amnesia=True)
    rounds = _jstep(sim, b, per_round=True)
    wiped = False
    for t, (got, o, want) in enumerate(zip(world[p]["amnesia"],
                                           one["amnesia"], rounds)):
        _check(got, o, want, ("round", t))
        # the materialized union's metadata widen; the view's
        # all-reduce, the append's, the winners' and the commit sum
        assert got["calls"]["all_gather"] == 1, t
        assert got["calls"]["all_reduce"] == 4, t
        wiped |= bool(t and (want["rows_vers"]
                             < rounds[t - 1]["rows_vers"]).any())
    assert wiped, "no owner lost its rows: the amnesia case does not bite"


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_sharded_matches_single_device_step_by_step(world, one, p):
    ref = jk.KafkaSim(8, 5, capacity=64, max_sends=2)
    shd = jk.KafkaSim(8, 5, capacity=64, max_sends=2, mesh=_jmesh(p))
    s1, s2 = ref.init_state(), shd.init_state()
    for t, (sk, sv, cr) in enumerate(K.programs_steps()):
        s1, s2 = ref.step(s1, sk, sv, cr), shd.step(s2, sk, sv, cr)
        want = _jstate(s2)
        _same(_jstate(s1), want, ("jax", t))
        _check(world[p]["programs_steps"][t], one["programs_steps"][t],
               want, t)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_run_rounds_sharded_matches_stepwise(world, one, p):
    b = K.stepwise_batches()
    sim = jk.KafkaSim(8, 5, capacity=64, max_sends=2, mesh=_jmesh(p))
    want = _jstate(sim.run_rounds(sim.init_state(), *b))
    for drv in ("rounds", "step"):
        key = ("run_rounds", drv)
        _check(world[p][key], one[key], want, key)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_kv_reach_on_mesh(world, one, p):
    import jax.numpy as jnp

    blocked, sks, svs, crs = K.window()
    sched = jc.KVReach(jnp.array([0], jnp.int32), jnp.array([2], jnp.int32),
                       jnp.asarray(blocked))
    sim = jk.KafkaSim(8, 3, capacity=16, max_sends=2, kv_retries=3,
                      kv_sched=sched, mesh=_jmesh(p))
    want = _jstate(sim.run_rounds(sim.init_state(), sks, svs, crs))
    _check(world[p]["kv_window"], one["kv_window"], want, "kv_window")
    free = jk.KafkaSim(8, 3, capacity=16, max_sends=2, kv_retries=3)
    st = free.run_rounds(free.init_state(), sks, svs, crs)
    assert want["kv_val"].sum() < int(np.asarray(st.kv_val).sum())


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_commit_free_path_on_mesh(world, one, p):
    sks, svs, crs = K.commit_free_batches()
    sim = jk.KafkaSim(8, 3, capacity=16, max_sends=2, mesh=_jmesh(p))
    want = _jstate(sim.run_rounds(sim.init_state(), sks, svs))
    _same(_jstate(sim.run_rounds(sim.init_state(), sks, svs, crs)), want,
          "jax explicit")
    for drv in ("auto", "explicit"):
        key = ("commit_free", drv)
        _check(world[p][key], one[key], want, key)


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_host_reads_on_every_rank(world, one, p):
    # every rank's reads agree (the world fixture) and equal the
    # reference's on its mesh
    b = K.staged(K.SCAN8, 12, 4, 2)
    sim = jk.KafkaSim(8, 4, capacity=64, max_sends=2, mesh=_jmesh(p),
                      fault_plan=_jplan(K.SCAN8))
    st = sim.run_fused(sim.init_state(), *b)
    nodes, keys, froms, sk = K.reads_queries(8, 4)
    offs, vals = sim.poll_batch(st, nodes, keys, froms)
    want = {"poll": [sim.poll(st, i, k, 0) for i in range(8)
                     for k in range(4)],
            "poll_batch": (offs, vals),
            "alloc_offsets": sim.alloc_offsets(st, sk),
            "list_committed": [sim.list_committed(st, i) for i in range(8)],
            "lin_kv": sim.lin_kv(st), "present_bool": sim.present_bool(st)}
    for src in (world[p]["reads"], one["reads"]):
        assert src["poll"] == want["poll"]
        assert src["list_committed"] == want["list_committed"]
        assert src["lin_kv"] == want["lin_kv"]
        for f in ("alloc_offsets", "present_bool"):
            np.testing.assert_array_equal(src[f], want[f])
        for a, w in zip(src["poll_batch"], want["poll_batch"]):
            np.testing.assert_array_equal(a, w)
    assert any(want["poll"]) and any(want["list_committed"])


@pytest.mark.parametrize("p", (4, 2))
def test_unique_ids_and_echo_on_mesh(world, one, p):
    ids = ju.UniqueIdsSim(64, max_per_round=4, mesh=_jmesh(p))
    st = ids.init_state()
    rng = np.random.default_rng(0)
    minted = []
    for _ in range(3):
        st, got = ids.step(st, rng.integers(0, 5, 64).astype(np.int32))
        minted.append(ids.format_ids(got))
    for src in (world[p]["ids"], one["ids"]):
        assert src["formatted"] == minted
        assert src["t"] == int(st.t)
        np.testing.assert_array_equal(src["minted"], np.asarray(st.minted))
    flat = [x for r in minted for x in r]
    assert len(flat) == len(set(flat))
    echo = je.EchoSim(8, mesh=_jmesh(p))
    payload = np.arange(32, dtype=np.int32).reshape(8, 4)
    st, replies = echo.step(echo.init_state(), payload, payload % 3 == 0)
    for src in (world[p]["echo"], one["echo"]):
        np.testing.assert_array_equal(src["replies"], np.asarray(replies))
        assert (src["t"], src["msgs"]) == (int(st.t), int(st.msgs))
    assert world[p]["echo"]["calls"] == {"ppermute": 0, "all_gather": 0,
                                         "all_reduce": 0}


def test_sims_task_kafka_digests_equal_reference(world):
    from gossip_glomers_tpu.parallel import dcn_worker as jdw

    want = jdw._task_sims(_jmesh(4))["kafka"]
    assert world["sims"]["kafka"] == want
    assert dcn_worker._task_sims(None, "cpu", ("kafka",)) == world["sims"]


# -- the block forms of the kernels' plain versions ------------------------------


def _nem_case(n, k, c, s, seed):
    """A faulted delivery problem: n rows, n s sends with distinct (key,
    slot) bits (a quarter none), and a crash + loss plan's liveness and
    coin operands at round 3 (returned with the plan)."""
    rng = np.random.default_rng(seed)
    wc, m = (c + 31) // 32, n * s
    cell = np.resize(rng.permutation(k * c), m)
    ok = (rng.random(m) < 0.75) & (np.arange(m) < k * c)
    keys, slot = cell // c, cell % c
    widx = np.where(ok, keys * wc + slot // 32, -1).astype(np.int32)
    bit = np.where(ok, np.uint32(1) << (slot % 32).astype(np.uint32),
                   0).astype(np.uint32)
    import jax.numpy as jnp

    plan = jf.NemesisSpec(n_nodes=n, seed=seed,
                          crash=((1, 6, tuple(range(seed % 3, n, 3))),),
                          loss_rate=0.35, loss_until=9).compile()
    up = np.array(jf.node_up(plan, jnp.int32(3),
                             jnp.arange(n, dtype=jnp.int32)))
    return widx, bit, up, dict(s_dim=s, t=3, seed=int(plan.seed),
                               loss_num=int(plan.loss_num)), plan


def _jax_nem(n, k, wc, widx, bit, up, kw, plan):
    # the reference's materialized faulted origin union (kafka.py
    # :527-544)
    import jax.numpy as jnp

    s = kw["s_dim"]
    g_origin = jnp.repeat(jnp.arange(n, dtype=jnp.int32), s)
    ids = jnp.arange(n, dtype=jnp.int32)
    drop = jf.edge_drop(plan, jnp.int32(kw["t"]), g_origin[None, :],
                        ids[:, None])
    recv = ((jnp.asarray(up)[:, None] & ~drop)
            | (g_origin[None, :] == ids[:, None]))
    w = jnp.asarray(np.where(widx >= 0, widx, k * wc))
    return np.asarray(jnp.zeros((n, k * wc), jnp.uint32).at[:, w].add(
        jnp.where(recv, jnp.asarray(bit)[None, :], jnp.uint32(0)),
        mode="drop")).reshape(n, k, wc)


def _i32(a):
    """A copy of ``a`` as an int32 tensor (uint32 words by their bits)."""
    return torch.from_numpy(np.array(a).view(np.int32))


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("seed", range(3))
def test_nem_deliver_block_form_equals_whole(shards, seed):
    """Each rank's rows (``row0``) against every visiting origin block
    (``origin0``), the steps ORed in (``accumulate``) in every order, and
    against all origins at once (the materialized form), equal the whole
    problem's delivery and the reference's."""
    n, k, c, s = 16, 5, 40, 2
    wc = (c + 31) // 32
    widx, bit, up, kw, plan = _nem_case(n, k, c, s, seed)
    whole = torch.full((n, k, wc), -1, dtype=torch.int32)
    kernels.kafka_nem_deliver(whole, _i32(widx), _i32(bit),
                              torch.from_numpy(up), lo=0, hi=n, **kw)
    want = _jax_nem(n, k, wc, widx, bit, up, kw, plan)
    np.testing.assert_array_equal(whole.numpy().view(np.uint32), want)
    b = n // shards
    for order in itertools.permutations(range(shards)):
        for r in range(shards):
            rows = slice(r * b, (r + 1) * b)
            blk = torch.full((b, k, wc), -1, dtype=torch.int32)
            for i, o in enumerate(order):
                ms = slice(o * b * s, (o + 1) * b * s)
                for lo in range(0, b, 3):
                    kernels.kafka_nem_deliver(
                        blk, _i32(widx[ms]), _i32(bit[ms]),
                        torch.from_numpy(up[rows].copy()), lo=lo,
                        hi=min(b, lo + 3), row0=r * b, origin0=o * b,
                        accumulate=i > 0, **kw)
            assert torch.equal(blk, whole[rows]), (order, r)
    for r in range(shards):
        rows = slice(r * b, (r + 1) * b)
        blk = torch.empty((b, k, wc), dtype=torch.int32)
        kernels.kafka_nem_deliver(blk, _i32(widx), _i32(bit),
                                  torch.from_numpy(up[rows].copy()), lo=0,
                                  hi=b, row0=r * b, **kw)
        assert torch.equal(blk, whole[rows]), r


def _commit_case(n, k, c, seed):
    rng = np.random.default_rng(seed)
    present = rng.integers(0, 1 << 32, (n, k, (c + 31) // 32),
                           dtype=np.uint64).astype(np.uint32)
    present &= rng.integers(0, 1 << 32, present.shape,
                            dtype=np.uint64).astype(np.uint32)
    union = np.bitwise_and.reduce(rng.integers(
        0, 1 << 32, (3, k, present.shape[-1]), dtype=np.uint64).astype(
        np.uint32))
    union[:, -1] &= np.uint32((1 << (c % 32 or 32)) - 1)
    lc = rng.integers(0, c // 2, (n, k)).astype(np.int32)
    req = np.where(rng.random((n, k)) < 0.6, rng.integers(-1, c + 3, (n, k)),
                   -1).astype(np.int32)
    kv_sent = np.where(rng.random(k) < 0.5, 0,
                       rng.integers(1, c + 2, k)).astype(np.int32)
    take, up, reach, tally = (rng.random(n) < q for q in (0.6, 0.8, 0.7,
                                                          0.5))
    return dict(present=present, union=union, lc=lc, req=req,
                kv_sent=kv_sent, take=take, up=up, reach=reach, tally=tally)


def _select(case, rows, row0=0, n_total=None):
    pt = _i32(case["present"][rows])
    lt = torch.from_numpy(case["lc"][rows].copy())
    out = kernels.kafka_commit_select(
        pt, lt, take=torch.from_numpy(case["take"][rows].copy()),
        union=_i32(case["union"]), req=torch.from_numpy(
            case["req"][rows].copy()),
        want_ok=torch.from_numpy(case["up"][rows].copy()),
        reach=torch.from_numpy(case["reach"][rows].copy()),
        kv_sent=torch.from_numpy(case["kv_sent"]),
        tally=torch.from_numpy(case["tally"][rows].copy()), row0=row0,
        n_total=n_total)
    return pt, lt, out


def _blocks_commit(case, shards, n, *, keep_row0=True, own_sentinel=False):
    """The commit passes over ``shards`` blocks, combined as the mesh
    combines them: the minimum CAS row, the maximum writer row, the sum
    of the counts and of the apply pass's partials, then the finish."""
    b = n // shards
    sel, akw = [], dict(kv_retries=7, tally_mult=2)
    for r in range(shards):
        rows = slice(r * b, (r + 1) * b)
        pt, lt, (cw, wl, cnt) = _select(case, rows,
                                        row0=r * b if keep_row0 else 0,
                                        n_total=n)
        if own_sentinel:             # the block's rows + 1 as "no CAS"
            cw = torch.where(cw == n + 1, b + 1, cw)
        sel.append((pt, lt, (cw, wl, cnt)))
    cas_win = torch.stack([x[2][0] for x in sel]).amin(0)
    wrt_last = torch.stack([x[2][1] for x in sel]).amax(0)
    counts = sum(x[2][2] for x in sel)
    parts = []
    for r, (pt, lt, _) in enumerate(sel):
        rows = slice(r * b, (r + 1) * b)
        parts.append(kernels.kafka_commit_apply(
            lt, torch.from_numpy(case["req"][rows].copy()), cas_win,
            wrt_last, torch.from_numpy(case["kv_sent"]),
            torch.from_numpy(case["reach"][rows].copy()),
            torch.from_numpy(case["up"][rows].copy()), None, None,
            row0=r * b if keep_row0 else 0, n_total=n, partial=True,
            **akw))
    kv, msgs = kernels.commit_finish(
        sum(x.to(torch.int64) for x in parts), cas_win, wrt_last,
        torch.from_numpy(case["kv_sent"]), counts,
        torch.tensor(4294967000), n_total=n, **akw)
    return (torch.cat([x[0] for x in sel]), torch.cat([x[1] for x in sel]),
            cas_win, wrt_last, counts, kv, msgs)


def _whole_commit(case, n):
    pt, lt, (cw, wl, counts) = _select(case, slice(0, n))
    kv, msgs = kernels.kafka_commit_apply(
        lt, torch.from_numpy(case["req"]), cw, wl,
        torch.from_numpy(case["kv_sent"]), torch.from_numpy(case["reach"]),
        torch.from_numpy(case["up"]), counts, torch.tensor(4294967000),
        kv_retries=7, tally_mult=2)
    return pt, lt, cw, wl, counts, kv, msgs


def _jax_commit(case, n):
    # the reference's classification, winners and cells (kafka.py
    # :711-780), as tests/test_torch_kernels.py holds them
    import jax.numpy as jnp
    from jax import lax

    def top_off(words):
        base = jnp.arange(words.shape[-1], dtype=jnp.int32) * 32
        return jnp.max(jnp.where(words > 0, base + 32
                                 - lax.clz(words).astype(jnp.int32), 0),
                       axis=-1)

    sync_new = jnp.where(jnp.asarray(case["take"])[:, None, None],
                         jnp.asarray(case["union"])[None]
                         & ~jnp.asarray(case["present"]), jnp.uint32(0))
    hwm = jnp.maximum(jnp.asarray(case["lc"]), top_off(sync_new))
    req, big = jnp.asarray(case["req"]), jnp.int32(n + 1)
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    want = (req >= 1) & jnp.asarray(case["up"])[:, None]
    dance = want & ~((hwm > 0) & (hwm >= req))
    active = dance & jnp.asarray(case["reach"])[:, None]
    readv = jnp.asarray(case["kv_sent"])[None, :]
    need_cas = active & (readv > 0) & (req > readv)
    writers = active & ~(readv > 0)
    read_only = active & (readv > 0) & (req <= readv)
    cas_win = jnp.min(jnp.where(need_cas, rows, big), axis=0)
    wrt_last = jnp.max(jnp.where(writers, rows, -1), axis=0)
    cas_req = jnp.sum(jnp.where(need_cas & (rows == cas_win[None]), req, 0),
                      axis=0)
    wrt_req = jnp.sum(jnp.where(writers & (rows == wrt_last[None]), req, 0),
                      axis=0)
    kv = jnp.where(cas_win < big, cas_req,
                   jnp.where(wrt_last >= 0, wrt_req, readv[0]))
    learn = jnp.where(need_cas & (rows == cas_win[None]), req,
                      jnp.where(read_only, readv,
                                jnp.where(writers, req, 0)))
    return (np.asarray(cas_win), np.asarray(wrt_last), np.asarray(kv),
            np.asarray(jnp.maximum(hwm, learn)))


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("seed", range(4))
def test_commit_block_forms_equal_whole(shards, seed):
    """The select pass's block form (global rows, the sim's sentinel) and
    the apply pass's partial form over 2 and 4 blocks, reduced across the
    blocks, equal the whole problem and the reference's round."""
    n, k, c = 16, 6, 40
    case = _commit_case(n, k, c, seed)
    whole = _whole_commit(case, n)
    got = _blocks_commit(case, shards, n)
    for a, b_, name in zip(got, whole, ("present", "lc", "cas_win",
                                        "wrt_last", "counts", "kv", "msgs")):
        assert torch.equal(a, b_), name
    cw, wl, kv, lc = _jax_commit(case, n)
    np.testing.assert_array_equal(got[2].numpy(), cw)
    np.testing.assert_array_equal(got[3].numpy(), wl)
    np.testing.assert_array_equal(got[5].numpy(), kv)
    np.testing.assert_array_equal(got[1].numpy(), lc)
    assert (cw < n).any() and (wl >= 0).any()


def test_block_form_mutants_fail():
    """Dropping ``row0`` (local rows as ids) or taking a block's own
    sentinel (its rows + 1) breaks the combined result; so does
    dropping ``origin0`` or ``accumulate`` in the ring."""
    n, shards = 16, 4
    hit_row0 = hit_sentinel = False
    for seed in range(4):
        case = _commit_case(n, 6, 40, seed)
        whole = _whole_commit(case, n)

        def differs(got):
            return any(not torch.equal(a, b_) for a, b_ in zip(got, whole))

        hit_row0 |= differs(_blocks_commit(case, shards, n,
                                           keep_row0=False))
        hit_sentinel |= differs(_blocks_commit(case, shards, n,
                                               own_sentinel=True))
    assert hit_row0 and hit_sentinel
    k, c, s = 5, 40, 2
    wc = (c + 31) // 32
    widx, bit, up, kw, _ = _nem_case(n, k, c, s, 0)
    whole = torch.empty((n, k, wc), dtype=torch.int32)
    kernels.kafka_nem_deliver(whole, _i32(widx), _i32(bit),
                              torch.from_numpy(up), lo=0, hi=n, **kw)
    b = n // shards
    for mutant in ("origin0", "accumulate", "row0"):
        bad = False
        for r in range(shards):
            rows = slice(r * b, (r + 1) * b)
            blk = torch.zeros((b, k, wc), dtype=torch.int32)
            for o in range(shards):
                ms = slice(o * b * s, (o + 1) * b * s)
                kernels.kafka_nem_deliver(
                    blk, _i32(widx[ms]), _i32(bit[ms]),
                    torch.from_numpy(up[rows].copy()), lo=0, hi=b,
                    row0=0 if mutant == "row0" else r * b,
                    origin0=0 if mutant == "origin0" else o * b,
                    accumulate=mutant != "accumulate" and o > 0, **kw)
            bad |= not torch.equal(blk, whole[rows])
        assert bad, mutant


def test_block_forms_check_their_rows():
    z3 = torch.zeros((4, 2, 1), dtype=torch.int32)
    z2 = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="block"):
        kernels.kafka_commit_select(z3, z2, row0=2, n_total=4)
    with pytest.raises(ValueError, match="M x 3"):
        kernels.kafka_nem_deliver(z3, torch.zeros(4, dtype=torch.int32),
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.ones(4, dtype=torch.bool), s_dim=3,
                                  lo=0, hi=4, t=0, seed=0, loss_num=0)
    with pytest.raises(ValueError, match="global ids"):
        kernels.kafka_nem_deliver(z3, torch.zeros(4, dtype=torch.int32),
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.ones(4, dtype=torch.bool), s_dim=1,
                                  lo=0, hi=4, t=0, seed=0, loss_num=0,
                                  row0=-1)


def _smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_digests_add_over_rank_blocks():
    """chip_smoke.py's mesh_kafka holds each rank's block of a state by
    digests: ``card_digest`` is ``dcn_worker.digest_array``, a field's
    digest is the sum of its blocks' at their global offsets, and a
    flipped bit changes its own block's digest alone."""
    from gossip_glomers_tpu_torch.tpu_sim.kafka import KafkaSim

    smoke = _smoke()
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, (12, 5, 3)).astype(np.int32))
    whole = smoke.card_digest(x, 0)
    assert whole == dcn_worker.digest_array(x.numpy())
    assert sum(smoke.card_digest(x[r * 3:(r + 1) * 3], r * 45)
               for r in range(4)) % 2**32 == whole
    sim = KafkaSim(8, 4, 64, max_sends=2, device="cpu",
                   fault_plan=_port_plan(K.SCAN8), resync_mode="push",
                   kv_backend="device")
    st = sim.run_rounds(sim.init_state(), *K.staged(K.SCAN8, 6, 4, 2))
    whole = smoke.kafka_digests(st, 0)
    blocks = [smoke.kafka_digests(st, r * 2, 2) for r in range(4)]
    for f in ("present", "local_committed", "origin_bits", "rows_vals",
              "rows_vers"):
        assert sum(b[f] for b in blocks) % 2**32 == whole[f], f
    for f in ("log_vals", "kv_val", "t", "msgs"):
        assert all(b[f] == whole[f] for b in blocks), f
    st.present[5, 1, 0] ^= 1 << 7
    flipped = [smoke.kafka_digests(st, r * 2, 2) for r in range(4)]
    assert [b["present"] != f["present"] for b, f in zip(blocks, flipped)] \
        == [False, False, True, False]


def _port_plan(kw):
    from gossip_glomers_tpu_torch.tpu_sim import faults

    return faults.NemesisSpec(**kw).compile(device="cpu")
