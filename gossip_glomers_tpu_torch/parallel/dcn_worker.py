"""The rank-side worker of a multi-process run, and its spawner.

The port of gossip_glomers_tpu/parallel/dcn_worker.py.  Each rank is one
process of a ``torch.distributed`` group on one device; :func:`spawn_world`
starts them (``torch.multiprocessing``, start method ``spawn``, the
group initialized through a ``file://`` store in a temporary directory,
so concurrent runs never share a port), runs ``fn(mesh, *args)`` on
every rank (``mesh`` the flat mesh of the whole world) and returns each
rank's result, or raises with every failed rank's traceback.  A rank that
hangs fails the call at its ``timeout``: the spawner kills the ranks.

:func:`spawn_local_cluster` runs the task list on every rank, on the flat
mesh or on ``pick_mesh_2d(hosts=)``, and writes one JSON report a rank
(``report.json.<rank>``); it asserts that every rank reports the same
replicated numbers (the per-rank timings aside).  Tasks, each on a 1-D
or a hierarchical mesh (or off a mesh):

- ``sims``: the reference's ``sims`` (the 16-node grid through the
  gather path, ``run`` and ``run_fused``: rounds, ``msgs`` and the state
  digest; the 8-node cas counter, ``run``, ``run_fused`` and a seed
  replay of 12 rounds: ``msgs`` and the state digest; the 8-node Kafka
  log, 6 steps of ``default_rng(0)`` sends: ``msgs`` and the state
  digest);
- ``batch``: a 64-scenario counter campaign, its verdict rows;
- ``certify``: a certified crash and loss broadcast campaign on the
  structured path;
- ``takeover``: a host's rows (the upper half of the nodes) crashed for
  a window, the flood converging after the restart;
- ``pipelined``: the ``sims`` body under ``GG_DCN_PIPELINE=1``;
- ``stale``: the counter allreduce campaign synchronous and at
  ``stale:4``, certified by ``check_staleness_bound`` (a hierarchical
  mesh);
- ``roundtime``: the words-major 4-ary tree flood's round wall over the
  halo exchange, at ``GG_DCN_RT_N`` nodes (65,536) and ``GG_DCN_RT_NV``
  values (32), and the state digest.

``main`` is the env-driven rank body
(``python -m gossip_glomers_tpu_torch.parallel.dcn_worker`` with the
``GG_*`` variables of :data:`.mesh.DIST_ENV`, ``GG_DCN_TASKS`` and
``GG_DCN_OUT``), on ``pick_mesh_2d()`` (the ranks grouped by machine)
when the world spans several machines, else on the flat mesh.
Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

#: report keys that are per-rank measurements, not replicated results
TIMING_KEYS = ("wall_s", "us_per_round")


# -- digests ---------------------------------------------------------------


def digest_array(a) -> int:
    """The reference's position-weighted uint32 checksum of an array: its
    4-byte words (narrower ones widened through int32) times ``i *
    2654435761 + 0x9E3779B9`` at flat position i, summed mod 2^32."""
    a = np.asarray(a)
    if a.dtype == np.bool_ or a.dtype.itemsize < 4:
        a = a.astype(np.int32)
    words = np.ascontiguousarray(a).reshape(-1).view(np.uint32)
    w = (np.arange(words.size, dtype=np.uint64) * 2654435761
         + 0x9E3779B9) & 0xFFFFFFFF
    return int((words.astype(np.uint64) * w & 0xFFFFFFFF).sum()
               & 0xFFFFFFFF)


def state_digest(state, mesh=None, *, node_dim: int = 1,
                 replicated: tuple = ()) -> dict:
    """Checksum every field of a sim state (a dataclass or a NamedTuple)
    into host ints, field-keyed (:func:`digest_array`).  On a mesh a
    tensor field is this rank's block of the node axis (``node_dim``: 1
    words-major, 0 node-major) and is gathered first, so every rank
    reports the global digest, unless it is empty or named in
    ``replicated`` (every rank holds all of it); host ints (``t``) and 0-d
    ledgers count as int32 / uint32 scalars."""
    import torch

    out = {}
    names = (state._fields if hasattr(state, "_fields")
             else [f.name for f in dataclasses.fields(state)])
    for name in names:
        value = getattr(state, name)
        if value is None:
            continue
        if isinstance(value, int):
            out[name] = digest_array(np.int32(value))
            continue
        if value.dim() >= 1 and mesh is not None and value.numel() \
                and name not in replicated:
            value = mesh.all_gather(value, dim=node_dim)
        arr = value.cpu().numpy()
        if value.dim() == 0 and value.dtype == torch.int64:
            arr = np.uint32(int(value) & 0xFFFFFFFF)
        out[name] = digest_array(arr)
    return out


# -- tasks -----------------------------------------------------------------


def _counter_half(mesh, device) -> dict:
    from ..tpu_sim.counter import CounterSim

    nc = 8
    deltas = np.arange(1, nc + 1, dtype=np.int32)
    out = {}
    for runner in ("run", "run_fused", "replay"):
        sim = CounterSim(nc, mode="cas", seed=7, mesh=mesh, device=device)
        state = getattr(sim, "run" if runner == "replay" else runner)(
            sim.add(sim.init_state(), deltas), 12)
        out[runner] = {"msgs": int(state.msgs),
                       "state": state_digest(state, mesh, node_dim=0)}
    if out["run"] != out["replay"]:
        raise AssertionError("counter seed replay diverged in-process")
    return out


def _kafka_half(mesh, device) -> dict:
    from ..tpu_sim.kafka import KafkaSim

    nc = 8
    rng = np.random.default_rng(0)
    sim = KafkaSim(nc, 4, capacity=32, mesh=mesh, device=device)
    state = sim.init_state()
    for _ in range(6):
        send_key = rng.integers(-1, 4, size=(nc, sim.max_sends)).astype(
            np.int32)
        send_val = rng.integers(0, 100, size=(nc, sim.max_sends)).astype(
            np.int32)
        state = sim.step(state, send_key, send_val)
    return {"msgs": int(state.msgs),
            "state": state_digest(state, mesh, node_dim=0,
                                  replicated=("log_vals", "kv_val"))}


def _sims_half(name: str, mesh, device) -> dict:
    if name == "counter":
        return _counter_half(mesh, device)
    if name == "kafka":
        return _kafka_half(mesh, device)
    if name != "broadcast":
        raise ValueError(f"no {name} half in the sims task")
    from ..tpu_sim.broadcast import BroadcastSim, make_inject
    from .topology import grid, to_padded_neighbors

    n, nv = 16, 16
    nbrs = to_padded_neighbors(grid(n))
    inject = make_inject(n, nv)
    out = {}
    for runner in ("run", "run_fused"):
        sim = BroadcastSim(nbrs, n_values=nv, mesh=mesh, device=device)
        state, rounds = getattr(sim, runner)(inject)
        out[runner] = {"rounds": int(rounds), "msgs": int(state.msgs),
                       "state": state_digest(state, mesh, node_dim=0)}
    return out


def _task_sims(mesh, device, halves=("broadcast", "counter", "kafka")
               ) -> dict:
    """The reference's ``sims`` task: its broadcast, counter and Kafka
    halves, or those named in ``halves``."""
    return {name: _sims_half(name, mesh, device) for name in halves}


def _task_roundtime(mesh, device) -> dict:
    """The round wall of the words-major tree flood over the halo
    exchange (ledger off, the closed-form round count): a per-rank time,
    and the state digest (replicated)."""
    import torch

    from ..tpu_sim import structured as S
    from ..tpu_sim.broadcast import BroadcastSim, make_inject
    from ..tpu_sim.engine import node_shards
    from ..tpu_sim.timing import discover_rounds
    from .topology import to_padded_neighbors, tree

    n = int(os.environ.get("GG_DCN_RT_N") or 65536)
    nv = int(os.environ.get("GG_DCN_RT_NV") or 32)
    sim = BroadcastSim(
        to_padded_neighbors(tree(n)), n_values=nv, sync_every=1 << 20,
        srv_ledger=False, mesh=mesh, exchange=S.make_exchange("tree", n),
        sharded_exchange=None if mesh is None
        else S.make_sharded_exchange("tree", n, node_shards(mesh)),
        device=device)
    rounds = discover_rounds("tree", n, nv)
    inject = make_inject(n, nv)
    sim.run_staged_fixed(sim.init_state(inject), rounds)   # warm
    state0 = sim.init_state(inject)
    sync = (torch.cuda.synchronize if sim.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = sim.run_staged_fixed(state0, rounds)
    sync()
    dt = time.perf_counter() - t0
    return {"n": n, "nv": nv, "rounds": rounds,
            "us_per_round": dt / rounds * 1e6,
            "state": state_digest(out, mesh)}


def _task_batch(mesh, device) -> dict:
    """The 64-scenario counter campaign (cas, poll every 2 rounds): each
    scenario's crashes moved past the cas drain, so every verdict row
    certifies; the rows' verdicts, rounds, messages and KV values."""
    from ..tpu_sim import scenario as SC
    from ..tpu_sim.faults import NemesisSpec, random_spec

    n, s_count = 16, 64
    specs = []
    for s in range(s_count):
        sp = random_spec(n, seed=s, horizon=8,
                         n_crash_windows=1 + (s % 2), loss_rate=0.1)
        meta = sp.to_meta()
        meta["crash"] = [[a + n + 2, b + n + 2, ns]
                         for a, b, ns in meta["crash"]]
        meta["loss_until"] += n + 2
        specs.append(NemesisSpec.from_meta(meta))
    batch = SC.ScenarioBatch(
        workload="counter",
        scenarios=tuple(SC.Scenario(spec=sp) for sp in specs),
        runner_kw={"mode": "cas", "poll_every": 2},
        max_recovery_rounds=32)
    res = SC.run_scenario_batch(batch, mesh=mesh, device=device)
    rows = [{k: row[k] for k in
             ("scenario", "ok", "converged_round", "msgs_total", "kv")}
            for row in res["scenarios"]]
    return {"ok": bool(res["ok"]), "n_scenarios": res["n_scenarios"],
            "failing": list(res["failing"]), "scenarios": rows}


def _task_certify(mesh, device) -> dict:
    """A certified 16-node tree campaign on the structured path under a
    crash and loss."""
    from ..harness.nemesis import run_broadcast_nemesis
    from ..tpu_sim.faults import NemesisSpec

    spec = NemesisSpec(n_nodes=16, seed=5, crash=((2, 4, (3, 9)),),
                       loss_rate=0.15, loss_until=5)
    res = run_broadcast_nemesis(spec, topology="tree", n_values=16,
                                structured=True, mesh=mesh, device=device)
    return {"ok": bool(res["ok"]),
            "converged_round": int(res["converged_round"]),
            "msgs_total": int(res["msgs_total"])}


def _task_takeover(mesh, device) -> dict:
    """Host loss: every row of the second host (the upper half of the
    nodes under the hosts-major layout) crashes for a window; the flood
    stalls on the survivors and converges after the restart.  Every
    value starts on node 0, so the wipe loses nothing."""
    from ..tpu_sim.broadcast import BroadcastSim
    from ..tpu_sim.faults import NemesisSpec
    from .topology import grid, to_padded_neighbors

    n, nv = 16, 16
    lost_host = tuple(range(n // 2, n))
    spec = NemesisSpec(n_nodes=n, seed=3, crash=((1, 6, lost_host),))
    dev = mesh.device if mesh is not None else device
    sim = BroadcastSim(to_padded_neighbors(grid(n)), n_values=nv,
                       mesh=mesh, fault_plan=spec.compile(device=dev),
                       device=None if mesh is not None else device)
    inject = np.zeros((n, 1), np.uint32)
    inject[0, 0] = np.uint32((1 << nv) - 1)
    state, rounds = sim.run(inject)
    reads = sim.read(state)
    converged = all(r == list(range(nv)) for r in reads)
    return {"rounds": int(rounds), "msgs": int(state.msgs),
            "lost_rows": list(lost_host), "converged": converged,
            "state": state_digest(state, mesh, node_dim=0)}


def _task_pipelined(mesh, device) -> dict:
    """The ``sims`` task with the hosts level pipelined
    (``GG_DCN_PIPELINE=1`` while it runs): bit-exact, so its digests are
    the synchronous run's and the flat mesh's."""
    old = os.environ.get("GG_DCN_PIPELINE")
    os.environ["GG_DCN_PIPELINE"] = "1"
    try:
        return _task_sims(mesh, device)
    finally:
        if old is None:
            os.environ.pop("GG_DCN_PIPELINE", None)
        else:
            os.environ["GG_DCN_PIPELINE"] = old


def _task_stale(mesh, device) -> dict:
    """The counter allreduce crash and loss campaign synchronous and at
    ``stale:4`` (a hierarchical mesh), certified by
    :func:`..harness.checkers.check_staleness_bound` against the
    synchronous twin; every number replicated."""
    from ..harness.checkers import check_staleness_bound
    from ..harness.nemesis import run_counter_nemesis
    from ..tpu_sim.faults import NemesisSpec

    spec = NemesisSpec(n_nodes=16, seed=3, crash=((1, 4, (2, 11)),),
                       loss_rate=0.2, loss_until=5)
    runs = {}
    for label, dcn in (("sync", "sync"), ("stale", "stale:4")):
        runs[label] = run_counter_nemesis(
            spec, mode="allreduce", mesh=mesh, max_recovery_rounds=32,
            dcn_mode=dcn, device=device)
    ok, details = check_staleness_bound(
        stale_k=4,
        sync_converged_round=runs["sync"]["converged_round"],
        stale_converged_round=runs["stale"]["converged_round"],
        lost_writes=runs["stale"]["lost_writes"],
        recovery=(runs["stale"]["ok"],
                  {"converged_round": runs["stale"]["converged_round"],
                   "kv": int(runs["stale"]["kv"])}))
    return {"ok": bool(ok),
            "sync_round": runs["sync"]["converged_round"],
            "stale_round": runs["stale"]["converged_round"],
            "delay_rounds": details["delay_rounds"],
            "bound_round": details["bound_round"],
            "kv": int(runs["stale"]["kv"]),
            "acked_sum": int(runs["stale"]["acked_sum"])}


TASKS = {"sims": _task_sims, "batch": _task_batch,
         "certify": _task_certify, "takeover": _task_takeover,
         "roundtime": _task_roundtime, "pipelined": _task_pipelined,
         "stale": _task_stale}


def run_tasks(tasks, mesh, timed: bool | None = None, *,
              device=None) -> dict:
    """Each named task's report on this rank; ``timed`` (default: the
    ``GG_DCN_TIME=1`` env) adds its ``wall_s``.  The tasks run on the
    mesh's device, or off a mesh on ``device`` (default CUDA, as
    :func:`..tpu_sim.engine.resolve_device` rules)."""
    from ..tpu_sim.engine import resolve_device

    if timed is None:
        timed = bool(os.environ.get("GG_DCN_TIME"))
    device = mesh.device if mesh is not None else resolve_device(device)
    out = {}
    for name in tasks:
        t0 = time.perf_counter()
        res = TASKS[name](mesh, device)
        if timed:
            res = dict(res, wall_s=time.perf_counter() - t0)
        out[name] = res
    return out


# -- the spawner -----------------------------------------------------------


def _rank_body(rank: int, world: int, store: str, backend: str, device,
               fn, args, out_dir: str, timeout_s: float) -> None:
    """One spawned rank: pin the device, join the group, run ``fn(mesh,
    *args)``, write its pickled result (or its traceback) to
    ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from .mesh import Mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # before any allocation: each rank's context on its own card
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            res = fn(Mesh(None, device=dev), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn_world(fn, n_procs: int, *, backend: str, device=None,
                args: tuple = (), timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_procs`` spawned ranks of one
    ``backend`` group, every rank's blocks on ``device`` (default CUDA,
    as :func:`..tpu_sim.engine.resolve_device` rules), and return their
    results in rank order.  ``fn`` must be importable by the ranks (a
    module-level function).  Raises with every failed rank's traceback
    if a rank fails, or if the world has not finished within ``timeout``
    seconds (the ranks are killed)."""
    import torch.multiprocessing as mp

    from ..tpu_sim.engine import resolve_device

    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="gg_world_")
    try:
        store = os.path.join(work, "store")
        procs = []
        for rank in range(n_procs):
            p = ctx.Process(target=_rank_body, daemon=True,
                            args=(rank, n_procs, store, backend,
                                  str(device), fn, args, work, timeout))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = []
        for rank, p in enumerate(procs):
            path = os.path.join(work, f"rank{rank}.err")
            if os.path.exists(path):
                with open(path) as fh:
                    errs.append(f"-- rank {rank} --\n{fh.read()[-3000:]}")
            elif p.exitcode != 0:
                errs.append(f"-- rank {rank} exit {p.exitcode} --")
        if late or errs:
            head = (f"ranks {late} still running after {timeout} s "
                    "(killed)\n" if late else "")
            raise RuntimeError(f"world of {n_procs} ({backend}, {device}) "
                               f"failed:\n{head}" + "\n".join(errs))
        out = []
        for rank in range(n_procs):
            with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _strip_timing(x):
    if isinstance(x, dict):
        return {k: _strip_timing(v) for k, v in x.items()
                if k not in TIMING_KEYS}
    return x


def _cluster_rank(world, tasks, out_path, timed, hosts=None):
    from .mesh import pick_mesh_2d

    mesh = world if hosts is None else pick_mesh_2d(hosts=hosts,
                                                    device=world.device)
    report = {"process_id": mesh.rank, "n_processes": mesh.size,
              "transport": mesh.transport,
              "mesh_shape": list(mesh.shape.values()),
              "tasks": run_tasks(tasks, mesh, timed)}
    with open(f"{out_path}.{mesh.rank}", "w") as fh:
        fh.write(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return report


def spawn_local_cluster(tasks: str, out_dir: str, *, n_procs: int = 2,
                        backend: str = "gloo", device=None,
                        timeout: float = 600.0,
                        timed: bool = False,
                        hosts: int | None = None) -> list:
    """Run the comma-separated ``tasks`` on ``n_procs`` spawned ranks
    (:func:`spawn_world`, on ``device``) and return the per-rank reports,
    each also written to ``out_dir/<run>/report.json.<rank>``.  Asserts
    that the ranks' replicated results agree (the per-rank timings,
    :data:`TIMING_KEYS`, aside).  ``hosts``: run on
    ``pick_mesh_2d(hosts=hosts)`` (the ranks folded into that many
    hosts) instead of the flat mesh of every rank."""
    names = [t for t in tasks.split(",") if t]
    for name in names:
        if name not in TASKS:
            raise ValueError(f"unknown task {name!r} (one of {sorted(TASKS)})")
    out = os.path.join(tempfile.mkdtemp(dir=out_dir), "report.json")
    reports = spawn_world(_cluster_rank, n_procs, backend=backend,
                          device=device, args=(names, out, timed, hosts),
                          timeout=timeout)
    first = _strip_timing(reports[0]["tasks"])
    for rep in reports[1:]:
        if _strip_timing(rep["tasks"]) != first:
            raise AssertionError(
                f"rank {rep['process_id']}'s replicated results differ "
                "from rank 0's")
    return reports


def main(argv=None) -> int:
    """The env-driven rank body: join the group (:func:`.mesh.
    init_distributed`), pick the mesh, run ``GG_DCN_TASKS`` on
    ``GG_DEVICE`` (default CUDA) and write the report to
    ``GG_DCN_OUT.<rank>`` (stdout without it)."""
    import torch.distributed as dist

    from ..tpu_sim.engine import resolve_device
    from .mesh import host_names, init_distributed, pick_mesh, pick_mesh_2d

    init_distributed()
    device = resolve_device(os.environ.get("GG_DEVICE") or None)
    # a world over several machines: the hosts axis, a host a machine;
    # on one machine the flat mesh
    machines = len(set(host_names())) if dist.is_initialized() else 1
    mesh = (pick_mesh_2d if machines > 1 else pick_mesh)(device=device)
    tasks = [t for t in os.environ.get("GG_DCN_TASKS",
                                       "sims").split(",") if t]
    rank = dist.get_rank() if dist.is_initialized() else 0
    report = {"process_id": rank,
              "n_processes": (dist.get_world_size()
                              if dist.is_initialized() else 1),
              "transport": None if mesh is None else mesh.transport,
              "mesh_shape": (None if mesh is None
                             else list(mesh.shape.values())),
              "tasks": run_tasks(tasks, mesh, device=device)}
    payload = json.dumps(report, indent=1, sort_keys=True) + "\n"
    out_path = os.environ.get("GG_DCN_OUT")
    if out_path:
        with open(f"{out_path}.{rank}", "w") as fh:
            fh.write(payload)
    else:
        sys.stdout.write(payload)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
