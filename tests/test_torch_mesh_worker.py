"""The rank-side worker (``parallel/dcn_worker.py``): its spawn contract,
its digests against the JAX package's, and its env-driven ``main``.

``spawn_local_cluster("sims,roundtime")`` runs 4 gloo ranks on the CPU;
every rank's replicated report agrees (the spawner asserts it), and the
broadcast half of ``sims`` (the reference's 16-node grid through the
gather path, ``run`` and ``run_fused``) equals the JAX package's sharded
BroadcastSim on its 4-device test mesh, digests included
(``state_digest`` against the reference's), and all three halves
(broadcast, counter, Kafka) equal the reference's ``sims`` task there.  ``main`` is driven as two
OS processes through the ``GG_*`` env contract."""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import torch_mesh_cases as C

from gossip_glomers_tpu.parallel import dcn_worker as jdw
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.parallel.topology import grid, to_padded_neighbors
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu_torch.parallel import dcn_worker

RT_N = 4096


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    old = os.environ.get("GG_DCN_RT_N")
    os.environ["GG_DCN_RT_N"] = str(RT_N)
    try:
        return dcn_worker.spawn_local_cluster(
            "sims,roundtime", str(tmp_path_factory.mktemp("cluster")),
            n_procs=4, device="cpu", timeout=90.0)
    finally:
        if old is None:
            os.environ.pop("GG_DCN_RT_N")
        else:
            os.environ["GG_DCN_RT_N"] = old


def test_cluster_reports_agree_and_equal_one_process(cluster):
    assert [r["process_id"] for r in cluster] == [0, 1, 2, 3]
    assert {r["transport"] for r in cluster} == {"gloo"}
    old = os.environ.get("GG_DCN_RT_N")
    os.environ["GG_DCN_RT_N"] = str(RT_N)
    try:
        one = dcn_worker.run_tasks(["sims", "roundtime"], None,
                                   device="cpu")
    finally:
        if old is None:
            os.environ.pop("GG_DCN_RT_N")
        else:
            os.environ["GG_DCN_RT_N"] = old
    strip = dcn_worker._strip_timing
    assert strip(cluster[0]["tasks"]) == strip(one)
    assert cluster[0]["tasks"]["roundtime"]["n"] == RT_N


def test_sims_broadcast_half_equals_reference(cluster):
    n, nv = 16, 16
    nbrs = to_padded_neighbors(grid(n))
    inject = jbc.make_inject(n, nv)
    mine = cluster[0]["tasks"]["sims"]["broadcast"]
    for runner in ("run", "run_fused"):
        sim = jbc.BroadcastSim(nbrs, n_values=nv, mesh=jpick_mesh(max_axis=4))
        state, rounds = getattr(sim, runner)(inject)
        want = {"rounds": int(rounds), "msgs": int(state.msgs),
                "state": jdw.state_digest(state)}
        assert mine[runner] == want, runner


def test_sims_three_halves_equal_reference(cluster):
    # the broadcast, counter and Kafka halves on 4 ranks against the
    # reference's sims task on its 4-device mesh, digests included
    want = jdw._task_sims(jpick_mesh(max_axis=4))
    mine = cluster[0]["tasks"]["sims"]
    assert set(mine) == {"broadcast", "counter", "kafka"}
    assert mine == want


def test_digest_matches_reference_digest():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for a in (rng.integers(0, 1 << 32, (5, 7), dtype=np.uint64).astype(
                  np.uint32),
              rng.integers(-9, 9, (11,)).astype(np.int32),
              np.array(True), np.int32(5), np.uint32(4000000000)):
        want = int(jdw._digest_fn(jnp)(jnp.asarray(a)))
        assert dcn_worker.digest_array(a) == want


def test_main_runs_from_the_env_contract(tmp_path):
    # two OS processes joined through GG_* (a file store), each writing
    # its report; the replicated results agree with the spawner's
    store = tmp_path / "store"
    out = tmp_path / "report.json"
    env = dict(os.environ, GG_COORDINATOR=f"file://{store}",
               GG_NUM_PROCS="2", GG_BACKEND="gloo", GG_DEVICE="cpu",
               GG_DCN_TASKS="sims", GG_DCN_OUT=str(out))
    env.pop("GG_DCN_TIME", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gossip_glomers_tpu_torch.parallel.dcn_worker"],
        env=dict(env, GG_PROC_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=90)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    reports = [json.loads((tmp_path / f"report.json.{r}").read_text())
               for r in range(2)]
    assert reports[0]["mesh_shape"] == [2]
    assert reports[0]["tasks"] == reports[1]["tasks"]
    one = dcn_worker.run_tasks(["sims"], None, device="cpu")
    assert reports[0]["tasks"] == json.loads(json.dumps(one))


def test_spawn_world_fails_a_hung_or_failed_world():
    with pytest.raises(RuntimeError, match="still running"):
        dcn_worker.spawn_world(C.hang_rank, 2, backend="gloo",
                               device="cpu", timeout=10.0)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        dcn_worker.spawn_world(C.fail_rank, 2, backend="gloo",
                               device="cpu", timeout=30.0)
    with pytest.raises(ValueError, match="unknown task"):
        dcn_worker.spawn_local_cluster("nope", tempfile.mkdtemp(),
                                       device="cpu")


def test_worker_runs_on_the_card_unless_told(monkeypatch):
    # no device named and no CUDA: the entry points raise, never fall
    # back to the CPU
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcn_worker.run_tasks(["sims"], None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcn_worker.spawn_world(C.fail_rank, 2, backend="gloo")
    monkeypatch.delenv("GG_DEVICE", raising=False)
    monkeypatch.delenv("GG_NUM_PROCS", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcn_worker.main()
