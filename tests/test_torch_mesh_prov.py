"""Provenance on a mesh: the three sims' ``run_observed(prov=)``,
``provenance_state`` and shard specs, the nemesis runners with provenance
on and ``replay_bundle(mesh=)``, against the JAX package's 8-device mesh,
on the reference's own mesh cases: tests/test_provenance.py
``test_broadcast_provenance_bit_exact``,
``test_broadcast_delays_provenance_bit_exact``,
``test_counter_provenance_bit_exact`` and
``test_kafka_provenance_bit_exact`` with ``mesh_on=True``, plus a
plan-free one hop under a partition window.

Every stamp, state and verdict is equal bit for bit on 4 ranks and on 2,
and equal to the port's one-process run.  The port runs in one spawned
world of 4 gloo ranks on the CPU (``torch_mesh_prov_cases``, its 2-rank
cases on a subgroup of ranks 0 and 1).  The traps a mesh sets are cases
of their own: the delay ring with three delay classes (a rank holds its
block of the ring, so the stamps read the slots the round has widened),
the counter's visibility stamp where the ranks' least caches differ (it
reads the least over the mesh), and a Kafka witness row that lives on
rank 2.  The collective census by kind is the port's own: broadcast
provenance adds nothing to the round's collectives, the counter's one
all-reduce a round (the least cache), Kafka's one (the packed stamps and
witness row)."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import torch_mesh_prov_cases as X
from gossip_glomers_tpu.harness import nemesis as JH
from gossip_glomers_tpu.harness import observe as JO
from gossip_glomers_tpu.parallel.topology import to_padded_neighbors, tree
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import provenance as JPV
from gossip_glomers_tpu.tpu_sim.broadcast import BroadcastSim as JB
from gossip_glomers_tpu.tpu_sim.broadcast import Partitions as JP
from gossip_glomers_tpu.tpu_sim.broadcast import make_inject
from gossip_glomers_tpu.tpu_sim.counter import CounterSim as JC
from gossip_glomers_tpu.tpu_sim.kafka import KafkaSim as JK
from gossip_glomers_tpu_torch.harness import nemesis as PH
from gossip_glomers_tpu_torch.parallel import dcn_worker
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import provenance as PPV

WORLD_TIMEOUT = 240.0
WALL = ("driven_s", "total_s", "ops_per_sec")


def mesh_1d():
    return JMesh(np.array(jax.devices()).reshape(8), ("nodes",))


def _norm(x):
    """A result as plain comparable data."""
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
    if isinstance(x, np.bool_):
        return bool(x)
    return x


def _result(a: dict, b: dict, what, skip=()) -> None:
    a, b = _norm(a), _norm(b)
    assert set(a) - set(WALL) == set(b) - set(WALL), (what, set(a) ^ set(b))
    for k in a:
        if k not in WALL and k not in skip:
            assert a[k] == b[k], (what, k)


def _strip(x):
    """A rank's result without what differs by rank: the collective
    census and the bundle-written flag (rank 0 writes)."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("calls", "plain_calls", "failed_written")}
    return x


# -- the bundles the ranks replay --------------------------------------------


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Failed campaigns' flight bundles, written by either package, with
    and without provenance (no recovery budget)."""
    out_dir = str(tmp_path_factory.mktemp("bundles"))
    spec = X.FAILED_SPEC
    small = X.RUNNER_SMALL
    out = {
        "jax_broadcast_prov": JH.run_broadcast_nemesis(
            JF.NemesisSpec(**spec), topology="tree", provenance=True,
            telemetry=True, max_recovery_rounds=0, observe_dir=out_dir),
        "jax_counter": JH.run_counter_nemesis(
            JF.NemesisSpec(**small), telemetry=True,
            max_recovery_rounds=0, observe_dir=out_dir),
        "port_counter_prov": PH.run_counter_nemesis(
            PF.NemesisSpec(**small), provenance=True,
            max_recovery_rounds=0, observe_dir=out_dir, device="cpu"),
        "port_kafka_prov": PH.run_kafka_nemesis(
            PF.NemesisSpec(**X.full_spec(16)),
            provenance=PPV.ProvenanceSpec("kafka", witness=X.WITNESSES[1]),
            telemetry=True, max_recovery_rounds=0, observe_dir=out_dir,
            device="cpu")}
    return {name: res["flight_bundle"] for name, res in out.items()}


@pytest.fixture(scope="module")
def world(bundles):
    ranks = dcn_worker.spawn_world(X.prov_world, 4, backend="gloo",
                                   device="cpu", args=(bundles,),
                                   timeout=WORLD_TIMEOUT)
    for p, members in ((4, ranks), (2, ranks[:2])):
        for r in members[1:]:
            assert _norm(_strip(r[p])) == _norm(_strip(members[0][p])), p
    return {4: ranks[0][4], 2: ranks[0][2], "ranks": ranks}


@pytest.fixture(scope="module")
def one(bundles):
    return X.prov_cases(None, bundles)


# -- the JAX package's runs ----------------------------------------------------


def _jbroadcast(way: str):
    n, nv, rounds = X.BROADCAST_N, X.BROADCAST_V, X.BROADCAST_ROUNDS[way]
    kw = X.broadcast_kw(way)
    spec = X.broadcast_spec(way)
    if spec is not None:
        kw["fault_plan"] = JF.NemesisSpec(**spec).compile()
    if way == "window":
        kw["parts"] = JP.from_meta({"starts": [X.WINDOW[0]],
                                    "ends": [X.WINDOW[1]],
                                    "group": X.window_group(n).tolist()})
    sim = JB(to_padded_neighbors(tree(n, branching=4)), mesh=mesh_1d(), **kw)
    inj = make_inject(n, nv)
    psp = JPV.ProvenanceSpec("broadcast")
    s1, _ = sim.stage(inj)
    obs, prov = sim.run_observed(s1, None, None, rounds, donate=True,
                                 prov=sim.provenance_state(psp, inj),
                                 prov_spec=psp)
    return ({"received": np.asarray(sim.received_node_major(obs)),
             "t": int(obs.t), "msgs": int(obs.msgs)},
            {k: np.asarray(v) for k, v in JPV.arrays_of(prov).items()})


def _u32(d: dict) -> dict:
    r = np.asarray(d["received"])
    return dict(d, received=r.view(np.uint32) if r.dtype == np.int32 else r)


def _same(mine: dict, want: dict, what) -> None:
    assert set(mine) == set(want), (what, set(mine) ^ set(want))
    for f, v in want.items():
        np.testing.assert_array_equal(np.asarray(mine[f]), np.asarray(v),
                                      err_msg=f"{what} {f}")


@pytest.mark.parametrize("way", X.BROADCAST_WAYS)
@pytest.mark.parametrize("p", (4, 2))
def test_broadcast_provenance_on_mesh(world, one, p, way):
    want_state, want_prov = _jbroadcast(way)
    got, o = world[p][("broadcast", way)], one[("broadcast", way)]
    for key in ("obs", "plain", "step"):
        _same(_u32(got[key]), want_state, (way, key))
        _same(_u32(got[key]), _u32(o[key]), ("one process", way, key))
    for key in ("prov", "prov_step"):
        _same(got[key], want_prov, (way, key))
        _same(got[key], o[key], ("one process", way, key))
    assert got["check_ok"] and o["check_ok"], got["problems"]
    assert (np.asarray(got["prov"]["arrival"]) > 0).any()
    # the stamps read the round's own gathered rows: no collective added
    assert got["calls"] == got["plain_calls"]
    if way == "delays":
        nbrs = to_padded_neighbors(tree(X.BROADCAST_N, branching=4))
        classes = np.unique(X.gather_delays(X.BROADCAST_N)[nbrs >= 0])
        assert len(classes) >= 2
        # one all-gather a delay class a round (the ring's own)
        assert 0 < got["calls"]["all_gather"] <= len(classes) * \
            X.BROADCAST_ROUNDS[way]


@pytest.mark.parametrize("p", (4, 2))
def test_counter_provenance_on_mesh(world, one, p):
    n, rounds = X.COUNTER_N, X.COUNTER_ROUNDS
    spec = JF.NemesisSpec(**X.full_spec(n))
    sim = JC(n, mode="cas", poll_every=2, fault_plan=spec.compile(),
             mesh=mesh_1d())
    deltas = np.arange(1, n + 1, dtype=np.int32)
    psp = JPV.ProvenanceSpec("counter")
    obs, prov = sim.run_observed(sim.add(sim.init_state(), deltas), None,
                                 None, rounds, donate=True,
                                 prov=sim.provenance_state(psp),
                                 prov_spec=psp)
    want = {"pending": np.asarray(obs.pending),
            "cached": np.asarray(obs.cached), "kv": int(obs.kv),
            "t": int(obs.t), "msgs": int(obs.msgs)}
    want_prov = {k: np.asarray(v) for k, v in JPV.arrays_of(prov).items()}
    got, o = world[p]["counter"], one["counter"]
    for key in ("obs", "plain", "step"):
        _same(got[key], want, key)
        _same(got[key], o[key], ("one process", key))
    for key in ("prov", "prov_step"):
        _same(got[key], want_prov, key)
        _same(got[key], o[key], ("one process", key))
    assert got["check_ok"], got["problems"]
    # the trap: the ranks' own least caches differ on some round whose
    # visibility stamp the mesh-wide least decides
    assert any(len(set(m)) > 1 for m in got["rank_mins"])
    assert (want_prov["visible_round"] > 0).any()
    # one all-reduce more a round: the least cache over the mesh
    extra = {k: got["calls"][k] - got["plain_calls"][k]
             for k in got["calls"]}
    assert extra == {"ppermute": 0, "all_gather": 0, "all_reduce": rounds}


@pytest.mark.parametrize("witness", X.WITNESSES)
@pytest.mark.parametrize("p", (4, 2))
def test_kafka_provenance_on_mesh(world, one, p, witness):
    n, k, rounds = X.KAFKA_N, X.KAFKA_K, X.KAFKA_ROUNDS
    spec = JF.NemesisSpec(**X.full_spec(n))
    sks, svs, crs = JH.stage_kafka_ops(spec, rounds, n_keys=k, max_sends=2,
                                       workload_seed=0)
    sim = JK(n, k, capacity=64, max_sends=2, fault_plan=spec.compile(),
             resync_every=4, mesh=mesh_1d())
    psp = JPV.ProvenanceSpec("kafka", witness=witness)
    obs, prov = sim.run_observed(sim.init_state(), None, None, sks, svs,
                                 crs, donate=True,
                                 prov=sim.provenance_state(psp),
                                 prov_spec=psp)
    want = {f: np.asarray(getattr(obs, f)) for f in (
        "present", "local_committed", "origin_bits", "log_vals", "kv_val")}
    want.update(t=int(obs.t), msgs=int(obs.msgs))
    want_prov = {f: np.asarray(v) for f, v in JPV.arrays_of(prov).items()}
    got, o = world[p][("kafka", witness)], one[("kafka", witness)]

    def u32(d):
        return {f: (np.asarray(v).view(np.uint32)
                    if f in ("present", "origin_bits") else v)
                for f, v in d.items()}

    for key in ("obs", "plain"):
        _same(u32(got[key]), u32(want), key)
        _same(u32(got[key]), u32(o[key]), ("one process", key))
    _same(got["prov"], want_prov, "prov")
    _same(got["prov"], o["prov"], ("one process", "prov"))
    assert got["check_ok"], got["problems"]
    assert (want_prov["first_present"] > 0).any()
    if witness == X.WITNESSES[1] and p == 4:
        assert witness // (n // p) == 2      # the witness row on rank 2
    # at most two all-reduces more a round (here one: the packed stamps
    # and witness row)
    extra = {kind: got["calls"][kind] - got["plain_calls"][kind]
             for kind in got["calls"]}
    assert extra["all_gather"] == 0 and extra["ppermute"] <= 0
    assert 0 < extra["all_reduce"] <= 2 * rounds


def test_shard_specs_are_the_reference_s():
    for port, ref in ((PPV.broadcast_specs(), JPV.broadcast_specs()),
                      (PPV.counter_specs(), JPV.counter_specs()),
                      (PPV.kafka_specs(), JPV.kafka_specs())):
        assert [tuple(x) for x in port] == [tuple(x) for x in ref]


# -- the runners and the replays -------------------------------------------------


def _jrunners() -> dict:
    m = mesh_1d()
    return {
        "broadcast": JH.run_broadcast_nemesis(
            JF.NemesisSpec(**X.RUNNER_BROADCAST), topology="tree",
            provenance=True, telemetry=True, mesh=m),
        "broadcast_delays": JH.run_broadcast_nemesis(
            JF.NemesisSpec(**X.DELAY_SPEC), topology="tree",
            delays=X.gather_delays(32), provenance=True, mesh=m),
        "counter": JH.run_counter_nemesis(
            JF.NemesisSpec(**X.RUNNER_SMALL), provenance=True,
            telemetry=True, mesh=m),
        "kafka": JH.run_kafka_nemesis(
            JF.NemesisSpec(**X.RUNNER_SMALL),
            provenance=JPV.ProvenanceSpec("kafka", witness=X.WITNESSES[1]),
            telemetry=True, mesh=m)}


@pytest.mark.parametrize("workload", ("broadcast", "broadcast_delays",
                                      "counter", "kafka"))
def test_nemesis_runners_with_provenance_on_mesh(world, one, workload):
    got = world[4]["runners"][workload]
    assert "provenance" in got
    _result(got, one["runners"][workload], "one process")
    _result(got, _jrunners()[workload], "jax")


def test_failed_campaign_bundle_written_once_and_replayed(world, one,
                                                          tmp_path):
    got, o = world[4]["runners"], one["runners"]
    want = JH.run_broadcast_nemesis(
        JF.NemesisSpec(**X.FAILED_SPEC), topology="tree", provenance=True,
        telemetry=True, max_recovery_rounds=0, observe_dir=str(tmp_path))
    path = want.pop("flight_bundle")
    assert not got["failed"]["ok"]
    _result(got["failed"], o["failed"], "one process")
    _result(got["failed"], want, "jax")
    assert got["failed_bundle"] == o["failed_bundle"] == \
        os.path.basename(path)
    # rank 0 writes the bundle, the others write nothing
    assert [r[4]["runners"]["failed_written"]
            for r in world["ranks"]] == [True, False, False, False]
    replay = got["failed_replay"]
    assert replay["first_divergence_round"] is None
    assert not replay["ok"]
    assert replay["lost_writes"] == got["failed"]["lost_writes"]
    _result(replay, o["failed_replay"], "one process")


def test_replay_bundle_on_mesh(world, one, bundles):
    got, o = world[4]["replays"], one["replays"]
    for name, path in bundles.items():
        want = JO.replay_bundle(path)
        assert got[name]["first_divergence_round"] is None, name
        assert not got[name]["ok"], name
        _result(got[name], o[name], ("one process", name))
        _result(got[name], want, ("jax", name), skip=("flight_bundle",))
    # a bundle naming a dcn_mode replays in it: the synchronous mode is
    # the bundle's own campaign, on the mesh as on one process
    first = sorted(bundles)[0]
    assert got["dcn_mode"]["first_divergence_round"] is None
    _result(got["dcn_mode"], o["dcn_mode"], "dcn_mode one process")
    _result(got["dcn_mode"], got[first], "dcn_mode bundle")


# -- the kernel's plain version on a rank's rows -----------------------------


def _block_inputs(mode: str, seed: int, n: int = 64, w: int = 2,
                  nv: int = 45, d: int = 5) -> dict:
    """A whole problem: new bits, stamps, a table of global ids with
    padded directions, and flag bytes with dup rows, or a stack of three
    widened ring slots with slot bytes (-1: nothing delivered)."""
    rng = np.random.default_rng(seed)
    nbrs = np.where(rng.random((n, d)) < 0.3, -1,
                    rng.integers(0, n, (n, d))).astype(np.int32)
    arrival = np.where(rng.random((n, nv)) < 0.4,
                       rng.integers(0, 6, (n, nv)), -1).astype(np.int32)
    parent = np.where(arrival > 0, rng.integers(-1, n, (n, nv)),
                      -1).astype(np.int32)
    keep = np.array([(1 << min(32, max(0, nv - 32 * c))) - 1
                     for c in range(w)], np.uint64).astype(np.uint32)
    new = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64).astype(
        np.uint32) & keep
    out = dict(new=new, nbrs=nbrs, arrival=arrival, parent=parent)
    if mode == "stack":
        out["src"] = rng.integers(0, 1 << 32, (3, n, w),
                                  dtype=np.uint64).astype(np.uint32)
        out["slots"] = np.where((nbrs >= 0) & (rng.random((n, d)) < 0.8),
                                rng.integers(0, 3, (n, d)), -1).astype(
            np.int8)
    else:
        out["src"] = rng.integers(0, 1 << 32, (n, w),
                                  dtype=np.uint64).astype(np.uint32)
        live = (nbrs >= 0) & (rng.random((n, d)) < 0.8)
        dele = live & (rng.random((n, d)) < 0.8)
        dup = dele & (rng.random((n, d)) < 0.4)
        out["flags"] = (live * 1 + dele * 2 + dup * 4).astype(np.uint8)
        out["dup"] = rng.integers(0, 1 << 32, (n, w),
                                  dtype=np.uint64).astype(np.uint32)
    return out


def _jterm(inp: dict, rows: slice):
    """The reference's delivered words of direction d for ``rows``."""
    import jax.numpy as jnp

    nb = inp["nbrs"][rows]
    src = inp["src"]

    def term(d):
        idx = np.clip(nb[:, d], 0, src.shape[-2] - 1)
        if "slots" in inp:
            s = inp["slots"][rows][:, d].astype(np.int64)
            got = src[np.clip(s, 0, None), idx]
            return jnp.asarray(np.where((s >= 0)[:, None], got, 0))
        f = inp["flags"][rows][:, d]
        t = np.where(((f & 2) != 0)[:, None], src[idx], 0)
        t = t | np.where(((f & 4) != 0)[:, None], inp["dup"][idx], 0)
        return jnp.asarray(t.astype(np.uint32))

    return term


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("mode", ("flags", "stack"))
def test_prov_attribute_on_a_ranks_rows_matches_reference(mode, shards):
    import jax.numpy as jnp
    import torch

    from gossip_glomers_tpu.tpu_sim.broadcast import _prov_attribute
    from gossip_glomers_tpu_torch.tpu_sim import kernels

    inp = _block_inputs(mode, 11 * shards + len(mode))
    n = inp["new"].shape[0]
    b = n // shards

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    def port(rows):
        arr = torch.from_numpy(inp["arrival"][rows].copy())
        par = torch.from_numpy(inp["parent"][rows].copy())
        edges = ({"slots": torch.from_numpy(inp["slots"][rows].copy())}
                 if mode == "stack" else
                 {"flags": torch.from_numpy(inp["flags"][rows].copy()),
                  "dup": i32(inp["dup"])})
        kernels.prov_attribute(i32(inp["new"][rows]), i32(inp["src"]),
                               torch.from_numpy(inp["nbrs"][rows].copy()),
                               arr, par, t_next=7, **edges)
        return arr.numpy(), par.numpy()

    whole = port(slice(None))
    arrs, pars = [], []
    for r in range(shards):
        rows = slice(r * b, (r + 1) * b)
        arr, par = port(rows)
        want = _prov_attribute(
            JPV.BroadcastProv(jnp.asarray(inp["arrival"][rows]),
                              jnp.asarray(inp["parent"][rows])),
            jnp.asarray(inp["new"][rows]), jnp.asarray(inp["nbrs"][rows]),
            _jterm(inp, rows), 7)
        np.testing.assert_array_equal(arr, np.asarray(want.arrival))
        np.testing.assert_array_equal(par, np.asarray(want.parent))
        arrs.append(arr)
        pars.append(par)
    np.testing.assert_array_equal(np.concatenate(arrs), whole[0])
    np.testing.assert_array_equal(np.concatenate(pars), whole[1])
    assert (whole[0] == 7).any()
