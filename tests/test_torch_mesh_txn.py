"""``TxnSim(mesh=)``, the traffic tracker and telemetry ring on a mesh,
the three sims' ``run_traffic`` / ``run_observed(tel)`` and the serving,
txn and nemesis runners' ``mesh=`` against the JAX package's sharded runs,
on the reference's own mesh cases: tests/test_txn.py
``test_step_run_fused_and_mesh_all_bit_exact`` (clean, under its plan,
and with ``kv_amnesia``); tests/test_traffic.py
``test_mesh_parity_and_conservation``; the ``mesh_on=True`` cases of
tests/test_telemetry.py (``test_counter_observed_bit_exact``,
``test_broadcast_observed_bit_exact``, ``test_kafka_observed_bit_exact``,
``test_traffic_telemetry_conservation``); tests/test_provenance.py
``test_traffic_through_delay_ring_modes``; tests/test_scenario.py
``test_traffic_through_wm_delay_ring_modes`` and
``test_serving_edge_delayed_wm_mode_mesh_parity``; and
``run_txn_nemesis(mesh=)`` with and without ``kv_amnesia``, the counter
and Kafka nemesis runners under traffic and telemetry, and the host reads
on every rank.

Every field is equal bit for bit on 4 ranks and on 2, and equal to the
port's one-process run.  The port runs in one spawned world of 4 gloo
ranks on the CPU (``torch_mesh_txn_cases``, its 2-rank cases on a
subgroup of ranks 0 and 1); the JAX package on ``pick_mesh(max_axis=P)``
of its virtual-device test mesh.  The collective census by kind is the
port's own: txn three all-reduces a round (the claim's minimum, the
view's sum, the packed requests and attempts), nothing else; the traffic
and telemetry rounds add all-reduces (and the AND circuit's ppermutes)
but no all-gather to what the sim's own round makes.

The block forms of the txn kernels' plain versions (``row0``,
``n_total``, ``view``) are held here too: a seeded problem split into 2
and 4 blocks, the blocks combined as the mesh combines them (the minimum
of the ``best`` partials, the sum of the requests and attempts), equals
the whole problem and the reference's round; the local row count in the
priority, or the commit reading the local rows, does not."""

import numpy as np
import pytest
import torch

import torch_mesh_txn_cases as X
from gossip_glomers_tpu.harness import nemesis as JH
from gossip_glomers_tpu.harness import serving as JSV
from gossip_glomers_tpu.harness import txn as JHT
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.parallel.topology import to_padded_neighbors, tree
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import structured as JS
from gossip_glomers_tpu.tpu_sim import telemetry as JTM
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu.tpu_sim import txn as JTX
from gossip_glomers_tpu.tpu_sim.broadcast import BroadcastSim as JB
from gossip_glomers_tpu.tpu_sim.broadcast import make_inject
from gossip_glomers_tpu.tpu_sim.counter import CounterSim as JC
from gossip_glomers_tpu.tpu_sim.kafka import KafkaSim as JK
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import kernels

WORLD_TIMEOUT = 240.0
WALL = ("driven_s", "total_s", "ops_per_sec")


def _norm(x):
    """A result as plain comparable data (arrays to lists, tuples to
    lists, numpy scalars to Python ones)."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def _agree(a, b, path=()):
    """Two ranks' results equal (the collective calls aside)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            if key != "calls" and not (isinstance(key, tuple)
                                       and key[-1] == "calls"):
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
    ranks = dcn_worker.spawn_world(X.txn_world, 4, backend="gloo",
                                   device="cpu", timeout=WORLD_TIMEOUT)
    for p, members in ((4, ranks), (2, ranks[:2])):
        for r in members[1:]:
            # a bundle is written by rank 0 only
            a = {k: v for k, v in members[0][p]["txn"].items()
                 if k != "nemesis_amnesia_written"}
            b = {k: v for k, v in r[p]["txn"].items()
                 if k != "nemesis_amnesia_written"}
            _agree(a, b, (p, "txn"))
            _agree(members[0][p]["traffic"], r[p]["traffic"],
                   (p, "traffic"))
    for r in ranks[1:]:
        _agree(ranks[0][4]["refusals"], r[4]["refusals"])
    return {4: ranks[0][4], 2: ranks[0][2]}


@pytest.fixture(scope="module")
def one():
    return {"txn": X.txn_cases(None), "traffic": X.traffic_cases(None)}


def _jmesh(p):
    return jpick_mesh(max_axis=p)


def _jplan(kw):
    return JF.NemesisSpec(**kw).compile()


def _same(mine: dict, want: dict, what) -> None:
    keys = set(k for k in mine if k != "calls")
    assert keys == set(want), (what, keys ^ set(want))
    for f, v in want.items():
        if isinstance(v, np.ndarray):
            assert mine[f].shape == v.shape, (what, f)
            np.testing.assert_array_equal(mine[f], v, err_msg=f"{what} {f}")
        else:
            assert mine[f] == v, (what, f, mine[f], v)


def _u32(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


# -- the JAX package's states as the cases' dicts ---------------------------


def _jtxn(st) -> dict:
    out = {f: np.asarray(getattr(st, f)) for f in (
        "arrived", "cur", "issue", "issue_round", "commit_round", "op_ver",
        "op_val")}
    out.update(rows_vals=np.asarray(st.rows.vals),
               rows_vers=np.asarray(st.rows.vers), t=int(st.t),
               msgs=int(st.msgs))
    return out


def _jtracker(ts) -> dict:
    out = {f: np.asarray(getattr(ts, f)) for f in (
        "issued_k", "issue_round", "done_round", "op_aux")}
    out.update({f: int(getattr(ts, f)) for f in (
        "arrived", "deferred", "completed", "deferred_resizing")})
    return out


def _jring(tel) -> dict:
    return {"ring": np.asarray(tel.ring).astype(np.int64),
            "wrote": int(tel.wrote)}


def _jcounter(st) -> dict:
    return {"pending": np.asarray(st.pending),
            "cached": np.asarray(st.cached), "kv": int(st.kv),
            "t": int(st.t), "msgs": int(st.msgs)}


def _mkafka(d: dict) -> dict:
    """A port Kafka state dict with its bit words as uint32."""
    return {k: _u32(v) if k in ("present", "origin_bits") else v
            for k, v in d.items()}


def _jkafka(st) -> dict:
    out = {f: np.asarray(getattr(st, f)) for f in (
        "present", "local_committed", "origin_bits", "log_vals", "kv_val")}
    out.update(t=int(st.t), msgs=int(st.msgs))
    return out


def _jbroadcast(sim, st) -> dict:
    return {"received": np.asarray(sim.received_node_major(st)),
            "t": int(st.t), "msgs": int(st.msgs)}


def _mbroadcast(d: dict) -> dict:
    return dict(d, received=_u32(d["received"]))


def _check(mine, one, want, what, conv=lambda d: d) -> None:
    _same(conv(mine), want, what)
    _same(conv(mine), conv(one), ("one process", what))


def _result(a: dict, b: dict, what, skip=()) -> None:
    a, b = _norm(a), _norm(b)
    assert set(a) - set(WALL) == set(b) - set(WALL), (what, set(a) ^ set(b))
    for k in a:
        if k not in WALL and k not in skip:
            assert a[k] == b[k], (what, k, a[k], b[k])


# -- txn -----------------------------------------------------------------------


def _jtxn_sim(way, p):
    plan = None if way == "clean" else _jplan(X.TXN_SPEC)
    return JTX.TxnSim(16, 8, fault_plan=plan, kv_amnesia=way == "amnesia",
                      mesh=_jmesh(p), **X.TXN_KW)


@pytest.mark.parametrize("way", X.TXN_WAYS)
@pytest.mark.parametrize("p", (4, 2))
def test_txn_step_run_fused_and_mesh_all_bit_exact(world, one, p, way):
    sim = _jtxn_sim(way, p)
    st, rounds = sim.init_state(), []
    for _ in range(X.TXN_ROUNDS):
        st = sim.step(st)
        rounds.append(_jtxn(st))
    mine, ones = world[p]["txn"], one["txn"]
    for t, (got, o, want) in enumerate(zip(mine[(way, "step")],
                                           ones[(way, "step")], rounds)):
        _check(got, o, want, (way, "round", t))
    for drv in ("run", "fused"):
        _check(mine[(way, drv)], ones[(way, drv)], rounds[-1], (way, drv))
    # all-reduces only: the claim's minimum, the view, the packed requests
    assert mine[(way, "calls")] == {"ppermute": 0, "all_gather": 0,
                                    "all_reduce": 3 * X.TXN_ROUNDS}


@pytest.mark.parametrize("p", (4, 2))
def test_txn_host_reads_on_every_rank(world, one, p):
    sim = JTX.TxnSim(16, 8, fault_plan=_jplan(X.TXN_SPEC), kv_amnesia=True,
                     **X.TXN_KW)
    st = sim.run(sim.init_state(), X.TXN_ROUNDS)
    want_h = JTX.history_of(st, sim.ops)
    want_f = JTX.final_registers(st, sim.layout)
    mine, ones = world[p]["txn"], one["txn"]
    assert _norm(mine[("amnesia", "history")]) == _norm(want_h) == _norm(
        ones[("amnesia", "history")])
    assert _norm(mine[("amnesia", "final")]) == _norm(want_f)
    assert mine[("amnesia", "provenance")] == JHT.txn_provenance_arrays(st)


@pytest.mark.parametrize("p", (4, 2))
def test_run_txn_nemesis_on_mesh(world, one, p):
    mine, ones = world[p]["txn"], one["txn"]
    want = JHT.run_txn_nemesis(JF.NemesisSpec(**X.NEM_TXN), **X.NEM_TXN_KW,
                               mesh=_jmesh(p))
    assert mine["nemesis"]["ok"] and want["ok"]
    _result(mine["nemesis"], ones["nemesis"], "one process")
    _result(mine["nemesis"], want, "jax", skip=("mesh",))
    owner = mine["owner"]
    bad = JF.NemesisSpec(**dict(X.NEM_TXN, crash=((3, 6, (owner,)),)))
    want = JHT.run_txn_nemesis(bad, kv_amnesia=True, **X.NEM_TXN_KW)
    got = mine["nemesis_amnesia"]
    assert not got["ok"] and not got["serializable"]
    lost = [q for q in got["serializability"]["problems"]
            if q["kind"] in ("lost-update", "lost-acked-commit")]
    assert lost and all(q["txns"] for q in lost)
    _result(got, ones["nemesis_amnesia"], "one process")
    _result(got, want, "jax", skip=("mesh", "flight_bundle"))
    assert mine["nemesis_amnesia_bundle"] == \
        one["txn"]["nemesis_amnesia_bundle"]
    assert mine["nemesis_amnesia_written"]


# -- traffic and telemetry -------------------------------------------------------


@pytest.mark.parametrize("p", (4, 2))
def test_mesh_parity_and_conservation(world, one, p):
    spec = JT.TrafficSpec(**X.TRAFFIC)
    sim = JC(16, mode="cas", poll_every=2, mesh=_jmesh(p))
    st, ts = sim.run_traffic(sim.init_state(), sim.traffic_state(spec),
                             spec, 24, donate=True)
    got, o = world[p]["traffic"]["counter_traffic"], \
        one["traffic"]["counter_traffic"]
    _check(got["ts"], o["ts"], _jtracker(ts), "tracker")
    _check(got["state"], o["state"], _jcounter(st), "state")
    assert got["summary"] == o["summary"] == JT.latency_summary(ts)
    assert got["summary"]["conserved"]
    assert got["series"] == o["series"] == JT.per_round_series(ts, 24)
    # a round: the counter's two, the issue, the least read, the scan
    assert got["calls"] == {"ppermute": 0, "all_gather": 0,
                            "all_reduce": 5 * 24}


@pytest.mark.parametrize("p", (4, 2))
def test_counter_observed_bit_exact(world, one, p):
    n, rounds = 16, 12
    sim = JC(n, mode="cas", poll_every=2, fault_plan=_jplan(X.full_spec(n)),
             mesh=_jmesh(p))
    deltas = np.arange(1, n + 1, dtype=np.int32)
    tsp = JTM.TelemetrySpec("counter", rounds=rounds)
    obs, tel = sim.run_observed(sim.add(sim.init_state(), deltas),
                                sim.telemetry_state(tsp), tsp, rounds,
                                donate=True)
    got, o = world[p]["traffic"]["counter_observed"], \
        one["traffic"]["counter_observed"]
    for key in ("obs", "plain", "step"):
        _check(got[key], o[key], _jcounter(obs), key)
    for key in ("tel", "tel_step"):
        _check(got[key], o[key], _jring(tel), key)
    # the counter's two all-reduces and the row's one packed sum
    assert got["calls"] == {"ppermute": 0, "all_gather": 0,
                            "all_reduce": 3 * rounds}


@pytest.mark.parametrize("structured", (False, True))
@pytest.mark.parametrize("p", (4, 2))
def test_broadcast_observed_bit_exact(world, one, p, structured):
    n, nv, rounds = 32, 64, 10
    spec = JF.NemesisSpec(**X.full_spec(n))
    kw = dict(n_values=nv, sync_every=4, srv_ledger=False,
              fault_plan=spec.compile(), mesh=_jmesh(p))
    if structured:
        kw["exchange"] = JS.make_exchange("tree", n, branching=4)
        kw["nemesis"] = JS.make_nemesis("tree", n, spec, n_shards=p,
                                        branching=4)
    sim = JB(to_padded_neighbors(tree(n, branching=4)), **kw)
    tsp = JTM.TelemetrySpec("broadcast", rounds=rounds)
    s1, _ = sim.stage(make_inject(n, nv))
    obs, tel = sim.run_observed(s1, sim.telemetry_state(tsp), tsp, rounds,
                                donate=True)
    got = world[p]["traffic"][("broadcast_observed", structured)]
    o = one["traffic"][("broadcast_observed", structured)]
    for key in ("obs", "plain"):
        _check(got[key], o[key], _jbroadcast(sim, obs), key, _mbroadcast)
    _check(got["tel"], o["tel"], _jring(tel), "tel")
    calls, plain = got["calls"], got["plain_calls"]
    # the row's one packed sum a round over the round's own collectives
    # (the gather path's payload all-gathers, the halo path's ppermutes)
    assert calls["all_gather"] == plain["all_gather"]
    assert calls["all_gather"] == 0 or not structured
    assert calls["all_reduce"] == plain["all_reduce"] + rounds


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_observed_bit_exact(world, one, p):
    n, k, rounds = 16, 4, 12
    spec = JF.NemesisSpec(**X.full_spec(n))
    sks, svs, crs = JH.stage_kafka_ops(spec, rounds, n_keys=k, max_sends=2,
                                       workload_seed=0)
    sim = JK(n, k, capacity=64, max_sends=2, fault_plan=spec.compile(),
             resync_every=4, mesh=_jmesh(p))
    tsp = JTM.TelemetrySpec("kafka", rounds=rounds, series=(
        "live_nodes", "alloc_total", "present_bits", "present_bits_full",
        "msgs"))
    obs, tel = sim.run_observed(sim.init_state(), sim.telemetry_state(tsp),
                                tsp, sks, svs, crs, donate=True)
    got, o = world[p]["traffic"]["kafka_observed"], \
        one["traffic"]["kafka_observed"]
    for key in ("obs", "plain"):
        _check(got[key], o[key], _jkafka(obs), key, _mkafka)
    _check(got["tel"], o["tel"], _jring(tel), "tel")
    # the materialized faulted union's metadata widen, one a round
    assert got["calls"]["all_gather"] == rounds


@pytest.mark.parametrize("p", (4, 2))
def test_traffic_telemetry_conservation(world, one, p):
    tspec = JT.TrafficSpec(**X.TEL_TRAFFIC)
    sim = JC(8, mode="cas", poll_every=2,
             fault_plan=_jplan(X.TEL_TRAFFIC_SPEC), mesh=_jmesh(p))
    tsp = JTM.TelemetrySpec("counter", rounds=16, traffic=True)
    st, ts, tel = sim.run_traffic(
        sim.init_state(), sim.traffic_state(tspec), tspec, 16, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    got, o = world[p]["traffic"]["counter_traffic_tel"], \
        one["traffic"]["counter_traffic_tel"]
    for key in ("state", "plain_state"):
        _check(got[key], o[key], _jcounter(st), key)
    for key in ("ts", "plain_ts"):
        _check(got[key], o[key], _jtracker(ts), key)
    _check(got["tel"], o["tel"], _jring(tel), "tel")
    assert got["summary"] == JT.latency_summary(ts)
    arrs = JTM.series_arrays(tel, tsp)
    assert all(a == i + d for a, i, d in
               zip(arrs["arrived"], arrs["issued"], arrs["deferred"]))
    # the traffic round's five, and the row's one packed sum
    assert got["calls"] == {"ppermute": 0, "all_gather": 0,
                            "all_reduce": 6 * 16}


@pytest.mark.parametrize("p", (4, 2))
def test_traffic_through_delay_ring_modes(world, one, p):
    n, nv = 32, 256
    sim = JB(to_padded_neighbors(tree(n, branching=4)), n_values=nv,
             sync_every=4, srv_ledger=False, delays=X.gather_delays(n),
             fault_plan=_jplan(X.DELAY_SPEC), mesh=_jmesh(p))
    tspec = JT.TrafficSpec(**X.DELAY_TRAFFIC)
    tsp = JTM.TelemetrySpec("broadcast", rounds=30, traffic=True)
    st, ts, tel = sim.run_traffic(
        sim.init_state(np.zeros((n, nv // 32), np.uint32)),
        sim.traffic_state(tspec), tspec, 30, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    got, o = world[p]["traffic"]["gather_delays_traffic"], \
        one["traffic"]["gather_delays_traffic"]
    _check(got["state"], o["state"], _jbroadcast(sim, st), "state",
           _mbroadcast)
    _check(got["ts"], o["ts"], _jtracker(ts), "tracker")
    _check(got["tel"], o["tel"], _jring(tel), "tel")
    summ = got["summary"]
    assert summ == JT.latency_summary(ts)
    assert summ["completed"] == summ["issued"] > 0 and summ["lat_p50"] >= 2


@pytest.mark.parametrize("p", (4, 2))
def test_kafka_traffic_on_mesh(world, one, p):
    tspec = JT.TrafficSpec(**X.RUNNER_TRAFFIC)
    sim = JK(16, 4, capacity=64, max_sends=2, resync_every=2, union_block=2,
             fault_plan=_jplan(X.RUNNER_SPEC), mesh=_jmesh(p))
    tsp = JTM.TelemetrySpec("kafka", rounds=14, traffic=True)
    st, ts, tel = sim.run_traffic(
        sim.init_state(), sim.traffic_state(tspec), tspec, 14, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    got, o = world[p]["traffic"]["kafka_traffic"], \
        one["traffic"]["kafka_traffic"]
    _check(got["state"], o["state"], _jkafka(st), "state", _mkafka)
    _check(got["ts"], o["ts"], _jtracker(ts), "tracker")
    _check(got["tel"], o["tel"], _jring(tel), "tel")
    # the blocked faulted union passes metadata round a ring: no all-gather
    assert got["calls"]["all_gather"] == 0


@pytest.mark.parametrize("p", (4, 2))
def test_traffic_through_wm_delay_ring_modes(world, one, p):
    want = JH.run_broadcast_nemesis(
        JF.NemesisSpec(**X.DELAY_SPEC), topology="tree",
        traffic=JT.TrafficSpec(**X.DELAY_TRAFFIC), dir_delays=(2, 1),
        structured=True, telemetry=True, mesh=_jmesh(p))
    got = world[p]["traffic"]["wm_delay_runner"]
    assert got["ok"] and got["completed"] > 0 and got["lat_p50"] >= 2
    assert got["mesh"] == p
    _result(got, one["traffic"]["wm_delay_runner"], "one process",
            skip=("mesh",))
    _result(got, want, "jax", skip=("mesh",))


@pytest.mark.parametrize("p", (4, 2))
def test_serving_edge_delayed_wm_mode_mesh_parity(world, one, p):
    kw = {"topology": "tree", "structured": True,
          "edge_delay_rows": X.edge_rows(32).tolist()}
    want = JSV.run_serving("broadcast", JT.TrafficSpec(**X.EDGE_TRAFFIC),
                           sim_kw=dict(kw), series=True, telemetry=True,
                           mesh=_jmesh(p))
    got = world[p]["traffic"]["edge_serving"]
    assert got["ok"] and want["ok"]
    _result(got, one["traffic"]["edge_serving"], "one process",
            skip=("mesh",))
    _result(got, want, "jax", skip=("mesh",))


@pytest.mark.parametrize("workload", ("counter", "kafka"))
@pytest.mark.parametrize("p", (4, 2))
def test_nemesis_runner_traffic_on_mesh(world, one, p, workload):
    spec = JF.NemesisSpec(**X.RUNNER_SPEC)
    tspec = JT.TrafficSpec(**X.RUNNER_TRAFFIC)
    extra = {} if workload == "counter" else dict(n_keys=4, capacity=64)
    want = getattr(JH, f"run_{workload}_nemesis")(
        spec, traffic=tspec, telemetry=True, mesh=_jmesh(p), **extra)
    got = world[p]["traffic"][f"{workload}_runner"]
    assert got["mesh"] == p
    _result(got, one["traffic"][f"{workload}_runner"], "one process",
            skip=("mesh",))
    _result(got, want, "jax", skip=("mesh",))


@pytest.mark.parametrize("workload", ("broadcast", "counter", "kafka"))
@pytest.mark.parametrize("p", (4, 2))
def test_nemesis_runner_campaign_on_mesh(world, one, p, workload):
    spec = JF.NemesisSpec(**(X.DELAY_SPEC if workload == "broadcast"
                             else X.RUNNER_SPEC))
    extra = dict(topology="tree") if workload == "broadcast" else {}
    want = getattr(JH, f"run_{workload}_nemesis")(
        spec, telemetry=True, mesh=_jmesh(p), **extra)
    got = world[p]["traffic"][f"{workload}_campaign"]
    _result(got, one["traffic"][f"{workload}_campaign"], "one process")
    _result(got, want, "jax")


#: the probes that raised item 10 on a mesh until provenance, the
#: scenario batches and dcn_mode ran there: each now equals its
#: one-process call
MESH_RUNS = ("broadcast_prov", "counter_prov", "broadcast_runner_prov",
             "counter_runner_prov", "kafka_runner_prov", "txn_frontier",
             "broadcast_runner_dcn", "counter_runner_dcn",
             "kafka_runner_dcn", "txn_dcn")


def test_mesh_refusals_name_item_10(world):
    refused = world[4]["refusals"]
    one = X.refusal_cases(None)
    assert set(refused) == set(one) == {
        "broadcast_prov", "counter_prov", "broadcast_runner_prov",
        "broadcast_runner_dcn", "counter_runner_prov", "counter_runner_dcn",
        "kafka_runner_prov", "kafka_runner_dcn", "txn_dcn", "txn_frontier"}
    assert set(refused) == set(MESH_RUNS)
    for name, got in refused.items():
        assert got[0] == "ran" and one[name][0] == "ran", (name, got)
        _result(got[1], one[name][1], ("one process", name))


# -- the txn kernels' block forms ---------------------------------------------


def _txn_problem(n: int, k: int, o: int, t_dim: int, seed: int):
    """A seeded txn round's operands over ``n`` nodes (numpy): keys distinct
    within a slot, every node active or not, issues -1 (a first attempt)
    or past the wrap (``issue * n`` beyond 2^31) so that an odd ``n``
    can give two nodes one priority; the store's rows and layout."""
    from gossip_glomers_tpu_torch.tpu_sim import kvstore

    rng = np.random.default_rng(seed)
    keys = np.stack([np.stack([rng.choice(k, o, replace=False)
                               for _ in range(t_dim)]) for _ in range(n)])
    issue = np.where(rng.random(n) < 0.3, -1,
                     rng.integers(0, 1 << 31, n) // max(1, n)
                     + rng.integers(0, 3, n) * ((1 << 31) // n))
    cur = rng.integers(0, t_dim + 1, n)
    active = rng.random(n) < 0.8
    if n % 2:
        # two nodes whose wrapped priorities are equal (n is odd, so
        # invertible mod 2^32): issue_j = issue_i + (i - j) / n, both
        # active on one slot's keys, so that both can win a key
        inv = pow(n, -1, 1 << 32)
        i, j = 1, 2
        if (5 + (i - j) * inv) % (1 << 32) >= 1 << 31:
            i, j = j, i
        issue[i], issue[j] = 5, (5 + (i - j) * inv) % (1 << 32)
        active[i] = active[j] = True
        cur[i] = cur[j] = 0
        keys[j, 0] = keys[i, 0]
    lay = kvstore.make_layout(k, n, seed=seed)
    return dict(
        keys=keys.astype(np.int32),
        write=rng.random((n, t_dim, o)) < 0.5,
        wval=rng.integers(1, 1 << 20, (n, t_dim, o)).astype(np.int32),
        cur=cur.astype(np.int32), issue=issue.astype(np.int32),
        active=active,
        op_ver=np.full((n, t_dim, o), -1, np.int32),
        op_val=np.full((n, t_dim, o), -1, np.int32),
        commit_round=np.full((n, t_dim), -1, np.int32),
        issue_round=np.full((n, t_dim), -1, np.int32),
        vals=rng.integers(0, 1 << 20, (n, lay.cap)).astype(np.int32),
        vers=rng.integers(0, 50, (n, lay.cap)).astype(np.int32), lay=lay)


def _blocks(pr: dict, shards: int, t: int, *, local_prio=False,
            own_rows=False):
    """The problem run as ``shards`` blocks combined as the mesh combines
    them.  ``local_prio``: the mutant whose priority takes the block's own
    row count and ids; ``own_rows``: the mutant whose commit reads the
    block's own rows at the owner's index (a remote owner's rows are then
    the block's)."""
    from gossip_glomers_tpu_torch.tpu_sim import kvstore

    n, k = pr["keys"].shape[0], pr["lay"].n_keys
    # the blocks need not be equal (a kernel's block form takes any rows)
    bounds = [round(i * n / shards) for i in range(shards + 1)]
    tt = {f: torch.from_numpy(np.ascontiguousarray(pr[f]))
          for f in pr if f != "lay"}
    slots = kvstore.key_slots(pr["lay"])
    rows = kvstore.KVRows(tt["vals"], tt["vers"])
    view = torch.stack([tt["vals"][slots.owner, slots.slot],
                        tt["vers"][slots.owner, slots.slot]])

    def blk(p):
        s = slice(bounds[p], bounds[p + 1])
        return {f: tt[f][s].clone() for f in (
            "keys", "write", "wval", "cur", "issue", "active", "op_ver",
            "op_val", "commit_round", "issue_round")}

    def where(p):
        rows = bounds[p + 1] - bounds[p]
        return (dict(row0=0, n_total=rows) if local_prio
                else dict(row0=bounds[p], n_total=n))

    parts = [blk(p) for p in range(shards)]
    claims = [kernels.txn_claim_plain(x["keys"], x["cur"], x["issue"],
                                      x["active"], t=t, n_keys=k,
                                      **where(p))
              for p, x in enumerate(parts)]
    best = torch.stack([c[0] for c in claims]).min(0).values
    attempts = sum(c[1] for c in claims)
    reqs, outs = [], []
    for p, x in enumerate(parts):
        read = dict(view=view)
        if own_rows:
            lo, hi = bounds[p], bounds[p + 1]
            read = dict(view=None)
            own = (rows.vals[lo:hi], rows.vers[lo:hi])
            out = kernels.txn_commit_plain(
                best, x["keys"], x["write"], x["wval"], x["cur"],
                x["issue"], x["active"],
                (slots.owner - lo).clamp(0, hi - lo - 1), slots.slot,
                *own, x["op_ver"], x["op_val"], x["commit_round"],
                x["issue_round"], t=t, **where(p), **read)
        else:
            out = kernels.txn_commit_plain(
                best, x["keys"], x["write"], x["wval"], x["cur"],
                x["issue"], x["active"], None, None, None, None,
                x["op_ver"], x["op_val"], x["commit_round"],
                x["issue_round"], t=t, **where(p), **read)
        reqs.append(out[0])
        outs.append(out[1:])
    req = sum(reqs)
    cat = [torch.cat([o[i] for o in outs]) for i in range(6)]
    return best, attempts, req, cat


def _whole(pr: dict, t: int):
    from gossip_glomers_tpu_torch.tpu_sim import kvstore

    tt = {f: torch.from_numpy(np.ascontiguousarray(pr[f]))
          for f in pr if f != "lay"}
    slots = kvstore.key_slots(pr["lay"])
    best, att = kernels.txn_claim_plain(tt["keys"], tt["cur"], tt["issue"],
                                        tt["active"], t=t,
                                        n_keys=pr["lay"].n_keys)
    out = kernels.txn_commit_plain(
        best, tt["keys"], tt["write"], tt["wval"], tt["cur"], tt["issue"],
        tt["active"], slots.owner, slots.slot, tt["vals"], tt["vers"],
        tt["op_ver"], tt["op_val"], tt["commit_round"], tt["issue_round"],
        t=t)
    return best, att, out[0], list(out[1:])


def _jax_round(pr: dict, t: int):
    """The reference's claim and commit expressions (txn.py:264-322) on
    the same operands, through its round with identity collectives."""
    import jax.numpy as jnp

    from gossip_glomers_tpu.tpu_sim import engine as JE
    from gossip_glomers_tpu.tpu_sim import kvstore as JKV

    n, t_dim, o = pr["keys"].shape
    k = pr["lay"].n_keys
    sim = JTX.TxnSim(n, k, txns_per_node=t_dim, ops_per_txn=o,
                     tspec=JT.TrafficSpec(n_nodes=n, n_clients=n,
                                          ops_per_client=t_dim, until=1,
                                          rate=1.0))
    sim.layout = pr["lay"]
    sim._key_at = jnp.asarray(pr["lay"].key_at)
    ops = JTX.TxnOps(jnp.asarray(pr["keys"]), jnp.asarray(pr["write"]),
                     jnp.asarray(pr["wval"]))
    # the round's own arrivals are off (until 1, t past it); arrived
    # set so that exactly the active nodes have an open slot
    arrived = np.where(pr["active"], t_dim + 1, pr["cur"]).astype(np.int32)
    st = JTX.TxnState(
        rows=JKV.KVRows(jnp.asarray(pr["vals"]), jnp.asarray(pr["vers"])),
        arrived=jnp.asarray(np.minimum(arrived, t_dim)),
        cur=jnp.asarray(pr["cur"]), issue=jnp.asarray(pr["issue"]),
        issue_round=jnp.asarray(pr["issue_round"]),
        commit_round=jnp.asarray(pr["commit_round"]),
        op_ver=jnp.asarray(pr["op_ver"]), op_val=jnp.asarray(pr["op_val"]),
        t=jnp.int32(t), msgs=jnp.uint32(0))
    return sim._round(st, ops, sim.tspec.compile(), JE.collectives(n))


# node counts: a power of two, even ones whose priorities wrap, odd ones
# (uneven blocks) with two nodes on one wrapped priority
BLOCK_CASES = [(16, 8, 2, 0), (24, 7, 3, 1), (40, 64, 2, 2), (21, 5, 1, 3),
               (35, 16, 4, 4), (9, 4, 2, 5)]


@pytest.mark.parametrize("n,k,o,seed", BLOCK_CASES)
@pytest.mark.parametrize("shards", (2, 4))
def test_txn_block_forms_combine_to_the_whole(n, k, o, seed, shards):
    pr = _txn_problem(n, k, o, 3, seed)
    t = 5
    best, att, req, outs = _blocks(pr, shards, t)
    wb, wa, wr, wo = _whole(pr, t)
    assert torch.equal(best, wb) and torch.equal(att, wa)
    assert torch.equal(req, wr)
    for a, b in zip(outs, wo):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,k,o,seed", BLOCK_CASES[::2])
def test_txn_block_forms_match_the_reference_round(n, k, o, seed):
    pr = _txn_problem(n, k, o, 3, seed)
    # the reference round needs its arrivals' clamp: cur <= T
    pr["cur"] = np.minimum(pr["cur"], 2).astype(np.int32)
    t = 5
    _best, _att, req, outs = _blocks(pr, 4, t)
    js = _jax_round(pr, t)
    for name, got in zip(("cur", "issue", "op_ver", "op_val",
                          "commit_round", "issue_round"), outs):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    # the requests land in the store: the reference's CAS of them
    from gossip_glomers_tpu_torch.tpu_sim import kvstore

    rows = kvstore.cas_ver_apply_at(
        kvstore.KVRows(torch.from_numpy(pr["vals"].copy()),
                       torch.from_numpy(pr["vers"].copy())),
        kvstore.key_slots(pr["lay"]), req[0] > 0, req[2], req[1])
    np.testing.assert_array_equal(rows.vals.numpy(),
                                  np.asarray(js.rows.vals))
    np.testing.assert_array_equal(rows.vers.numpy(),
                                  np.asarray(js.rows.vers))


def test_txn_block_form_mutants_fail():
    """The local row count in the priority, or the commit reading the
    block's own rows, must give another result than the whole problem."""
    pr = _txn_problem(32, 8, 2, 3, 9)
    t = 5
    wb, _wa, wr, wo = _whole(pr, t)
    best, _, req, outs = _blocks(pr, 4, t, local_prio=True)
    assert not (torch.equal(best, wb) and torch.equal(req, wr)
                and all(torch.equal(a, b) for a, b in zip(outs, wo)))
    _, _, req, outs = _blocks(pr, 4, t, own_rows=True)
    assert not (torch.equal(req, wr)
                and all(torch.equal(a, b) for a, b in zip(outs, wo)))


def test_txn_block_form_wrappers_check_rows():
    pr = _txn_problem(8, 4, 2, 2, 0)
    tt = {f: torch.from_numpy(np.ascontiguousarray(pr[f]))
          for f in pr if f != "lay"}
    with pytest.raises(ValueError, match="rows"):
        kernels.txn_claim(tt["keys"], tt["cur"], tt["issue"], tt["active"],
                          t=1, n_keys=4, row0=4, n_total=8)
    best, _ = kernels.txn_claim(tt["keys"], tt["cur"], tt["issue"],
                                tt["active"], t=1, n_keys=4, row0=8,
                                n_total=16)
    with pytest.raises(ValueError, match="view"):
        kernels.txn_commit(best, tt["keys"], tt["write"], tt["wval"],
                           tt["cur"], tt["issue"], tt["active"], None, None,
                           None, None, tt["op_ver"], tt["op_val"],
                           tt["commit_round"], tt["issue_round"], t=1,
                           view=torch.zeros((2, 3), dtype=torch.int32),
                           row0=8, n_total=16)
