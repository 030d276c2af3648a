"""The port's nemesis campaign runners (gossip_glomers_tpu_torch/harness/
nemesis.py) against the JAX package's on the CPU: each ``run_*_nemesis``
result dict equals the reference's on every field (the runners report no
wall clock), for the campaigns of tests/test_nemesis.py, with observation
off and with telemetry and provenance on; the port's ``stage_kafka_ops``
and its copied checkers equal the originals on seeded inputs."""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import checkers as JC
from gossip_glomers_tpu.harness import nemesis as JN
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu.tpu_sim import traffic as JT
from gossip_glomers_tpu_torch.harness import checkers as PC
from gossip_glomers_tpu_torch.harness import nemesis as PN
from gossip_glomers_tpu_torch.harness import observe as PO
from gossip_glomers_tpu_torch.tpu_sim import faults as PF
from gossip_glomers_tpu_torch.tpu_sim import traffic as PT


def _norm(x):
    """A result as plain JSON-like data (numpy arrays to lists)."""
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


def assert_same_result(want: dict, got: dict) -> None:
    want, got = _norm(want), _norm(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


SPEC = dict(n_nodes=16, seed=7, crash=((3, 8, (2, 5, 11)),),
            loss_rate=0.2, loss_until=10, dup_rate=0.1, dup_until=10)


def _parts(n, cut=4, start=3, end=6):
    groups = np.zeros((1, n), np.int8)
    groups[0, :cut] = 1
    return {"starts": [start], "ends": [end], "group": groups.tolist()}


def _delays(n):
    from gossip_glomers_tpu.parallel.topology import grid, to_padded_neighbors
    nbrs = to_padded_neighbors(grid(n))
    rng = np.random.default_rng(0)
    return np.where(nbrs >= 0, rng.integers(1, 4, nbrs.shape),
                    1).astype(np.int32)


# (runner, spec kwargs, runner kwargs) — tests/test_nemesis.py's
# campaigns: :114, :130 (the structured path and the tree with dup), :153,
# :163, :173, :184, :213, :238's resync modes and :492's full matrix
# (partitions, per-edge delays, crash and loss on the grid)
CAMPAIGNS = {
    "broadcast_parts": ("broadcast", SPEC, dict(parts=_parts(16))),
    "broadcast_reseeded": ("broadcast", dict(SPEC, seed=8),
                           dict(parts=_parts(16))),
    "broadcast_structured": ("broadcast", SPEC,
                             dict(parts=_parts(16), structured=True)),
    "broadcast_tree_dup": ("broadcast",
                           dict(n_nodes=16, seed=7, crash=((3, 8, (4, 9)),),
                                dup_rate=0.1, dup_until=10),
                           dict(topology="tree")),
    "broadcast_tree_dup_structured": (
        "broadcast", dict(n_nodes=16, seed=7, crash=((3, 8, (4, 9)),),
                          dup_rate=0.1, dup_until=10),
        dict(topology="tree", structured=True)),
    "broadcast_delays_parts": (
        "broadcast", dict(n_nodes=16, seed=3, crash=((4, 9, (1, 6)),),
                          loss_rate=0.15, loss_until=12),
        dict(n_values=24, parts=_parts(16), delays=_delays(16))),
    "counter_drained": ("counter",
                        dict(n_nodes=12, seed=5, crash=((14, 20, (3, 7)),),
                             loss_rate=0.15, loss_until=22), {}),
    "counter_amnesia": ("counter",
                        dict(n_nodes=12, seed=5, crash=((1, 4, (0, 1)),)),
                        {}),
    "counter_allreduce_blocked": (
        "counter", dict(n_nodes=12, seed=5, crash=((6, 9, (3, 7)),),
                        loss_rate=0.15, loss_until=10),
        dict(mode="allreduce", union_block=4)),
    "kafka_pull": ("kafka",
                   dict(n_nodes=8, seed=11, crash=((3, 7, (1, 4)),),
                        loss_rate=0.25, loss_until=10), {}),
    "kafka_push": ("kafka",
                   dict(n_nodes=8, seed=11, crash=((3, 7, (1, 4)),),
                        loss_rate=0.25, loss_until=10),
                   dict(resync_mode="push")),
    "kafka_push_crashed_origin": ("kafka",
                                  dict(n_nodes=6, seed=3,
                                       crash=((1, 9, (0,)),)),
                                  dict(resync_mode="push",
                                       workload_seed=2)),
    "kafka_send_only_blocked": (
        "kafka", dict(n_nodes=16, seed=2, crash=((1, 4, (3, 9)),),
                      loss_rate=0.1, loss_until=4),
        dict(commits=False, send_prob=0.5, union_block=4, rounds=6)),
}
# membership: a late joiner and a leaver on each runner
MEMBERSHIP = dict(n_nodes=12, seed=5, crash=((2, 4, (3,)),),
                  loss_rate=0.1, loss_until=6, join=((3, (5,)),),
                  leave=((7, (8,)),))
CAMPAIGNS.update({
    "broadcast_membership": ("broadcast", MEMBERSHIP, {}),
    "counter_membership": ("counter", MEMBERSHIP, {}),
    "kafka_membership": ("kafka", MEMBERSHIP, {}),
})
OBSERVE = {"off": {}, "observed": dict(telemetry=True, provenance=True)}


def _run(mod, kind: str, spec_kw: dict, kw: dict, observe: dict):
    faults = JF if mod is JN else PF
    run = getattr(mod, f"run_{kind}_nemesis")
    extra = {} if mod is JN else {"device": "cpu"}
    if observe and kw.get("structured"):
        # provenance rides the gather path: the structured campaigns
        # record the telemetry ring alone
        observe = dict(telemetry=True)
    return run(faults.NemesisSpec(**spec_kw), **kw, **observe, **extra)


@pytest.mark.parametrize("observe", sorted(OBSERVE))
@pytest.mark.parametrize("case", sorted(CAMPAIGNS))
def test_runner_result_matches_reference(case, observe):
    kind, spec_kw, kw = CAMPAIGNS[case]
    want = _run(JN, kind, spec_kw, kw, OBSERVE[observe])
    got = _run(PN, kind, spec_kw, kw, OBSERVE[observe])
    assert_same_result(want, got)
    if OBSERVE[observe]:
        assert "telemetry" in got
        assert ("provenance" in got) == (not kw.get("structured"))


def test_runner_observation_leaves_the_campaign_alone():
    # observation on equals observation off on every campaign field
    for case in ("broadcast_parts", "counter_drained", "kafka_push"):
        kind, spec_kw, kw = CAMPAIGNS[case]
        off = _run(PN, kind, spec_kw, kw, {})
        on = _run(PN, kind, spec_kw, kw, OBSERVE["observed"])
        on.pop("telemetry")
        on.pop("provenance")
        assert on.pop("ok") <= off.pop("ok")
        assert_same_result(off, on)


@pytest.mark.parametrize("kind", ("broadcast", "counter", "kafka"))
def test_traffic_campaign_hands_off_to_serving(kind):
    tkw = dict(n_nodes=16, n_clients=8, ops_per_client=2, until=6,
               rate=0.5, seed=3)
    spec_kw = dict(n_nodes=16, seed=4, crash=((2, 5, (1, 6)),))
    want = getattr(JN, f"run_{kind}_nemesis")(
        JF.NemesisSpec(**spec_kw), traffic=JT.TrafficSpec(**tkw))
    got = getattr(PN, f"run_{kind}_nemesis")(
        PF.NemesisSpec(**spec_kw), traffic=PT.TrafficSpec(**tkw),
        device="cpu")
    for clock in ("driven_s", "total_s", "ops_per_sec"):
        want.pop(clock)
        got.pop(clock)
    assert_same_result(want, got)


@pytest.mark.parametrize("commits", (True, False))
@pytest.mark.parametrize("quiesce", (0, 3))
def test_stage_kafka_ops_is_the_reference_staging(commits, quiesce):
    for n, seed in ((64, 2), (97, 5)):
        kw = dict(n_nodes=n, seed=seed, crash=((1, 6, (0, 3, n - 1)),),
                  join=((2, (9,)),), leave=((5, (4,)),))
        for a, b in zip(
                PN.stage_kafka_ops(PF.NemesisSpec(**kw), 12, n_keys=16,
                                   max_sends=1, commits=commits,
                                   quiesce=quiesce),
                JN.stage_kafka_ops(JF.NemesisSpec(**kw), 12, n_keys=16,
                                   max_sends=1, commits=commits,
                                   quiesce=quiesce)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_runner_refusals_match_reference():
    spec_kw = dict(n_nodes=8, seed=3, crash=((2, 4, (1,)),))
    tkw = dict(n_nodes=8, n_clients=8, ops_per_client=2, until=4,
               rate=0.5, seed=1)
    for mod, faults, tr, extra in ((JN, JF, JT, {}),
                                   (PN, PF, PT, {"device": "cpu"})):
        spec = faults.NemesisSpec(**spec_kw)
        with pytest.raises(ValueError, match="traffic"):
            mod.run_counter_nemesis(spec, traffic=tr.TrafficSpec(**tkw),
                                    provenance=True, **extra)
        with pytest.raises(ValueError, match="gather"):
            mod.run_broadcast_nemesis(spec, structured=True,
                                      provenance=True, **extra)
        with pytest.raises(ValueError, match="structured"):
            mod.run_broadcast_nemesis(spec, delays=np.ones((8, 4)),
                                      structured=True, **extra)
        with pytest.raises(ValueError, match="dir_delays"):
            mod.run_broadcast_nemesis(spec, dir_delays=(1, 2), **extra)
        with pytest.raises(ValueError, match="topology"):
            mod.run_broadcast_nemesis(spec, topology="ring", **extra)
        with pytest.raises(ValueError, match="resync_mode"):
            mod.run_kafka_nemesis(spec, resync_mode="gossip", **extra)
    spec = PF.NemesisSpec(**spec_kw)
    for run in (PN.run_broadcast_nemesis, PN.run_counter_nemesis,
                PN.run_kafka_nemesis):
        # a mesh is the port's parallel.mesh.Mesh
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            run(spec, device="cpu", mesh=object())
    # dcn_mode runs and is recorded: off a mesh the synchronous mode is
    # the run without it, and the reference's run in that mode
    jspec = JF.NemesisSpec(**spec_kw)
    for prun, jrun, kw in (
            (PN.run_broadcast_nemesis, JN.run_broadcast_nemesis,
             dict(n_values=16)),
            (PN.run_counter_nemesis, JN.run_counter_nemesis, {}),
            (PN.run_kafka_nemesis, JN.run_kafka_nemesis, {})):
        got = prun(spec, device="cpu", dcn_mode="sync", **kw)
        plain = prun(spec, device="cpu", **kw)
        want = jrun(jspec, dcn_mode="sync", **kw)
        for key in ("ok", "converged_round", "msgs_total",
                    "n_lost_writes"):
            assert got[key] == plain[key] == want[key], (prun, key)
    # observe_dir runs: each runner's failed campaign (no recovery
    # budget) writes its flight bundle there, as the reference's does
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        for run, kind in ((PN.run_broadcast_nemesis, "broadcast"),
                          (PN.run_counter_nemesis, "counter"),
                          (PN.run_kafka_nemesis, "kafka")):
            res = run(spec, device="cpu", observe_dir=out,
                      max_recovery_rounds=0)
            assert not res["ok"]
            bundle = PO.load_bundle(res["flight_bundle"])
            assert (bundle["kind"], bundle["workload"]) == ("nemesis", kind)
            assert bundle["nemesis"] == spec.to_meta()


def test_runners_run_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = PF.NemesisSpec(n_nodes=8, seed=3, crash=((2, 4, (1,)),))
    for run in (PN.run_broadcast_nemesis, PN.run_counter_nemesis,
                PN.run_kafka_nemesis):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(spec)


def test_helpers_match_reference():
    assert PN._failure_of({"clear_round": 3, "ok": True, "lost_writes": []}) \
        == JN._failure_of({"clear_round": 3, "ok": True, "lost_writes": []})
    for tel, prov in ((None, None), (1, None), (None, 2), (1, 2)):
        out = ("s",) + ((tel,) if tel else ()) + ((prov,) if prov else ())
        if tel is None and prov is None:
            out = "s"
        assert PN._unpack_obs(out, tel, prov) == JN._unpack_obs(out, tel,
                                                               prov)
    for topo in ("grid", "tree"):
        np.testing.assert_array_equal(PN._neighbors(topo, 23),
                                      JN._neighbors(topo, 23))
    for p in (None, False):
        PN._no_traffic_provenance(p)
    with pytest.raises(ValueError, match="provenance"):
        PN._no_traffic_provenance(True)


# -- the copied checkers on seeded inputs --------------------------------


CHECK_RECOVERY = [
    dict(clear_round=10, converged_round=14, max_recovery_rounds=8,
         lost_writes=[], msgs_at_clear=100, msgs_at_converged=120),
    dict(clear_round=10, converged_round=None, max_recovery_rounds=8,
         lost_writes=[]),
    dict(clear_round=10, converged_round=12, max_recovery_rounds=8,
         lost_writes=[(0, 1)]),
    dict(clear_round=10, converged_round=30, max_recovery_rounds=8,
         lost_writes=[]),
    dict(clear_round=4, converged_round=6, max_recovery_rounds=8,
         lost_writes=[], divergence=3),
]


@pytest.mark.parametrize("i", range(len(CHECK_RECOVERY)))
def test_check_recovery_matches_reference(i):
    assert PC.check_recovery(**CHECK_RECOVERY[i]) \
        == JC.check_recovery(**CHECK_RECOVERY[i])


@pytest.mark.parametrize("seed", range(6))
def test_parts_cut_and_divergence_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    meta = {"starts": [1, 4], "ends": [5, 9],
            "group": rng.integers(0, 3, (2, n)).tolist()}
    a, b = rng.integers(0, n, 50), rng.integers(0, n, 50)
    for t in range(11):
        for m in (meta, None):
            np.testing.assert_array_equal(PC._parts_cut(m, t, a, b),
                                          JC._parts_cut(m, t, a, b))
    x = {"arrival": rng.integers(-1, 9, (n, 5)).astype(np.int32),
         "parent": rng.integers(-1, n, (n, 5)).astype(np.int32)}
    y = {k: v.copy() for k, v in x.items()}
    assert PC.provenance_divergence_round(x, y) is None
    y["parent"][rng.integers(0, n), rng.integers(0, 5)] += 1
    y["arrival"][rng.integers(0, n), rng.integers(0, 5)] += 2
    assert PC.provenance_divergence_round(x, y) \
        == JC.provenance_divergence_round(x, y)
    z = {"arrival": np.zeros((n + 1, 5), np.int32)}
    assert PC.provenance_divergence_round(x, z) \
        == JC.provenance_divergence_round(x, z) == 0


def _forge(rng, arrs: dict) -> dict:
    """A copy of a record with a few random cells rewritten."""
    out = {k: np.array(v) for k, v in arrs.items()}
    for key, a in out.items():
        flat = a.reshape(-1)
        for j in rng.integers(0, flat.size, 3):
            flat[j] = int(rng.integers(-1, max(3, int(a.max()) + 2)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_check_provenance_matches_reference(seed):
    """The verdict and details of the copied certifier on real records
    (each workload's observed campaign) and on forged copies of them."""
    rng = np.random.default_rng(seed)
    for case in ("broadcast_parts", "counter_drained", "kafka_pull"):
        kind, spec_kw, kw = CAMPAIGNS[case]
        res = _run(PN, kind, spec_kw, kw, OBSERVE["observed"])
        arrs = res["provenance"]["arrays"]
        if kind == "broadcast":
            from gossip_glomers_tpu_torch.parallel.topology import (
                grid, to_padded_neighbors)
            from gossip_glomers_tpu_torch.tpu_sim.engine import (
                host_unpack_bits)
            ctx = dict(nbrs=to_padded_neighbors(grid(16)),
                       received=host_unpack_bits(
                           np.full((16, 1), 0xFFFFFFFF, np.uint32), 32),
                       msgs_total=res["msgs_total"], parts=kw["parts"])
        elif kind == "counter":
            ctx = dict(final_kv=res["kv"])
        else:
            ctx = dict(n_nodes=8, resync_every=4, resync_mode="pull",
                       witness=0)
        for rec in (arrs, _forge(rng, arrs)):
            for sk in (spec_kw, None):
                want = JC.check_provenance(
                    kind, rec, spec=None if sk is None
                    else JF.NemesisSpec(**sk), **ctx)
                got = PC.check_provenance(
                    kind, rec, spec=None if sk is None
                    else PF.NemesisSpec(**sk), **ctx)
                assert _norm(got) == _norm(want)
