"""Rank-side cases of tests/test_torch_mesh_kafka.py: module-level
functions that a spawned rank of ``dcn_worker.spawn_world`` runs as
``fn(mesh)``, and that the tests also run in one process (``mesh=None``,
on the CPU).  One world runs every case on the whole 4-rank mesh and on a
2-rank mesh of ranks 0 and 1.  Inputs are made from seeds with numpy by
the functions below, which the tests also call to build the JAX
package's runs; states come back as numpy, their node blocks gathered,
so every rank reports the global ones.  No JAX here: the ranks import
this module."""

import numpy as np

from torch_mesh_fault_cases import _before, _calls, _dev, _on, _sub
from gossip_glomers_tpu_torch.harness import nemesis as H
from gossip_glomers_tpu_torch.tpu_sim import faults
from gossip_glomers_tpu_torch.tpu_sim.counter import KVReach
from gossip_glomers_tpu_torch.tpu_sim.echo import EchoSim
from gossip_glomers_tpu_torch.tpu_sim.kafka import KafkaSim
from gossip_glomers_tpu_torch.tpu_sim.unique_ids import UniqueIdsSim

#: tests/test_engine.py's _nem_spec (crash, loss, dup) at 8 nodes
NEM8 = dict(n_nodes=8, seed=11, crash=((3, 7, (1, 4)),), loss_rate=0.25,
            loss_until=10, dup_rate=0.1, dup_until=10)
#: tests/test_nemesis.py's crash + loss spec at 8 nodes (no dup)
SCAN8 = dict(n_nodes=8, seed=11, crash=((3, 7, (1, 4)),), loss_rate=0.25,
             loss_until=10)
#: tests/test_nemesis.py's three-way parity spec at 16 nodes
NEM16 = dict(n_nodes=16, seed=11, crash=((3, 7, (1, 4)),), loss_rate=0.25,
             loss_until=10, dup_rate=0.1, dup_until=10)
#: the device KV under kv_amnesia: owners of keys 1, 3 and 7 (nodes 2
#: and 7 at 16 nodes) crash and restart empty
AMNESIA16 = dict(n_nodes=16, seed=5, crash=((2, 5, (2, 7, 9, 14)),),
                 loss_rate=0.2, loss_until=9)
#: the three-way parity's union_block settings, by way
THREE_WAY = {"blocked": dict(union_block=1),
             "materialized": dict(union_block="materialized"),
             "matmul": dict(repl_fast=False)}


def batches(n, k, s, r, seed, with_commits=True):
    """tests/test_engine.py's _kafka_batches."""
    rng = np.random.default_rng(seed)
    sks = rng.integers(-1, k, (r, n, s)).astype(np.int32)
    svs = rng.integers(0, 1000, (r, n, s)).astype(np.int32)
    crs = None
    if with_commits:
        crs = np.where(rng.random((r, n, k)) < 0.2,
                       rng.integers(1, 6, (r, n, k)), -1).astype(np.int32)
    return sks, svs, crs


def staged(spec_kw: dict, rounds: int, k: int, s: int):
    """The nemesis runner's seeded sends and commits for a spec."""
    return H.stage_kafka_ops(faults.NemesisSpec(**spec_kw), rounds,
                             n_keys=k, max_sends=s)


def programs_steps():
    """tests/test_tpu_sim_programs.py's sharded-vs-single steps (:177):
    six rounds of (sends, values, commits)."""
    n, rng = 8, np.random.default_rng(1)
    out = []
    for r in range(6):
        sk = rng.integers(-1, 5, (n, 2)).astype(np.int32)
        sv = rng.integers(0, 1000, (n, 2)).astype(np.int32)
        cr = np.full((n, 5), -1, np.int32)
        if r % 2:
            cr[r % n, r % 5] = r
        out.append((sk, sv, cr))
    return out


def stepwise_batches():
    """tests/test_tpu_sim_programs.py's run_rounds batches (:270)."""
    n, k, s, r = 8, 5, 2, 6
    rng = np.random.default_rng(3)
    sks = rng.integers(-1, k, (r, n, s)).astype(np.int32)
    svs = rng.integers(0, 1000, (r, n, s)).astype(np.int32)
    crs = np.full((r, n, k), -1, np.int32)
    crs[2, 1, 2] = 1
    crs[4, 3, 0] = 4
    return sks, svs, crs


def window():
    """tests/test_tpu_sim_programs.py's KV window (:459): the first half
    of 8 nodes blocked over rounds [0, 2), and its batches."""
    n, k = 8, 3
    blocked = np.zeros((1, n), bool)
    blocked[0, : n // 2] = True
    rng = np.random.default_rng(4)
    sks = rng.integers(0, k, (3, n, 2)).astype(np.int32)
    svs = rng.integers(0, 100, (3, n, 2)).astype(np.int32)
    crs = np.where(rng.random((3, n, k)) < 0.3,
                   rng.integers(1, 5, (3, n, k)), -1).astype(np.int32)
    return blocked, sks, svs, crs


def commit_free_batches():
    """tests/test_tpu_sim_programs.py's commit-free batches (:489)."""
    n, k = 8, 3
    rng = np.random.default_rng(9)
    sks = rng.integers(-1, k, (4, n, 2)).astype(np.int32)
    svs = rng.integers(0, 100, (4, n, 2)).astype(np.int32)
    return sks, svs, np.full((4, n, k), -1, np.int32)


def reads_queries(n: int, k: int):
    """The host reads' queries: (nodes, keys, from_offsets) and a send
    batch for alloc_offsets."""
    rng = np.random.default_rng(23)
    q = 24
    sk = rng.integers(-1, k, (n, 2)).astype(np.int32)
    return (rng.integers(0, n, q).astype(np.int32),
            rng.integers(0, k, q).astype(np.int32),
            rng.integers(0, 6, q).astype(np.int32), sk)


def drive_kafka(sim) -> list:
    """tests/test_kvstore.py's _drive_kafka: a scripted allocator and
    commit dance, the observable trail after each phase (cells, every
    node's committed offsets, the ledger) and every node's poll."""
    n = 8
    st = sim.init_state()
    trail = []

    def snap(st):
        trail.append((sim.lin_kv(st),
                      {i: sim.list_committed(st, i) for i in range(n)},
                      int(st.msgs)))

    sk = np.full((n, 1), -1, np.int32)
    sv = np.zeros((n, 1), np.int32)
    sk[0:4, 0] = 0
    sk[4:6, 0] = 1
    sv[0:6, 0] = np.arange(10, 16, dtype=np.int32)
    st = sim.step(st, sk, sv)
    snap(st)
    cr = np.full((n, 2), -1, np.int32)
    cr[0, 0] = 2
    cr[6, 0] = 1
    cr[4, 1] = 1
    st = sim.step(st, commit_req=cr)
    snap(st)
    sk2 = np.full((n, 1), -1, np.int32)
    sv2 = np.zeros((n, 1), np.int32)
    sk2[7, 0] = 0
    sv2[7, 0] = 99
    st = sim.step(st, sk2, sv2)
    cr2 = np.full((n, 2), -1, np.int32)
    cr2[2, 0] = 4
    cr2[3, 0] = 4
    st = sim.step(st, commit_req=cr2)
    snap(st)
    trail.append([sim.poll(st, i, 0, 0) for i in range(n)])
    return trail


def kstate(sim, st) -> dict:
    """Every field of a Kafka state as numpy (uint32 views of the bit
    words), node blocks gathered on a mesh (a collective)."""
    mesh = sim.mesh

    def full(x):
        if mesh is None:
            return x.cpu().numpy()
        if not x.numel():          # origin_bits off the push resync
            return np.zeros((sim.n_nodes,) + tuple(x.shape[1:]), np.int32)
        return mesh.all_gather(x).cpu().numpy()

    out = {"log_vals": st.log_vals.cpu().numpy(),
           "present": full(st.present).view(np.uint32),
           "kv_val": st.kv_val.cpu().numpy(),
           "local_committed": full(st.local_committed),
           "origin_bits": full(st.origin_bits).view(np.uint32),
           "t": int(st.t), "msgs": int(st.msgs)}
    if st.rows is not None:
        out["rows_vals"] = full(st.rows.vals)
        out["rows_vers"] = full(st.rows.vers)
    return out


def _full(mesh, x):
    """A rank's node block gathered (a collective); ``x`` off a mesh."""
    return x if mesh is None else mesh.all_gather(x)


def _run(sim, fn, mesh):
    """``fn()``'s state and the collectives it made, by kind."""
    before = _before(mesh)
    st = fn()
    calls = _calls(mesh, before)
    return dict(kstate(sim, st), calls=calls)


def _stepwise(sim, batches_, mesh, per_round: bool = False):
    sks, svs, crs = batches_
    st = sim.init_state()
    rounds = []
    for i in range(sks.shape[0]):
        before = _before(mesh)
        st = sim.step(st, sks[i], svs[i], None if crs is None else crs[i])
        if per_round:
            calls = _calls(mesh, before)
            rounds.append(dict(kstate(sim, st), calls=calls))
    return rounds if per_round else kstate(sim, st)


def kafka_cases(mesh) -> dict:
    """The reference's Kafka mesh cases, and push, kv_amnesia and the
    host reads, on this mesh (or in one process on the CPU)."""
    out = {}
    on = _on(mesh)
    dev = _dev(mesh)

    def plan(kw):
        return faults.NemesisSpec(**kw).compile(device=dev)

    # tests/test_engine.py:214: the union against the matmul oracle,
    # run_rounds and stepwise
    b = batches(8, 5, 2, 6, seed=11)
    for name, kw in (("fast", {}), ("slow", dict(repl_fast=False))):
        sim = KafkaSim(8, 5, 64, max_sends=2, **kw, **on)
        out[("fast_matmul", name, "rounds")] = _run(
            sim, lambda: sim.run_rounds(sim.init_state(), *b), mesh)
        out[("fast_matmul", name, "step")] = _stepwise(sim, b, mesh)
    # :250: run_fused against run_rounds
    b = batches(8, 5, 2, 5, seed=13)
    sim = KafkaSim(8, 5, 64, max_sends=2, **on)
    out[("fused", "rounds")] = kstate(sim, sim.run_rounds(sim.init_state(),
                                                          *b))
    out[("fused", "fused")] = kstate(sim, sim.run_fused(sim.init_state(),
                                                        *b))
    # :264: the sharded union
    b = batches(8, 5, 2, 6, seed=17)
    sim = KafkaSim(8, 5, 64, max_sends=2, **on)
    out["sharded_union"] = kstate(sim, sim.run_rounds(sim.init_state(), *b))
    # :288: the faulted union against the matmul oracle under crash,
    # loss and dup
    b = staged(NEM8, 12, 4, 2)
    for name, kw in (("fast", {}), ("slow", dict(repl_fast=False))):
        sim = KafkaSim(8, 4, 64, max_sends=2, fault_plan=plan(NEM8), **kw,
                       **on)
        out[("faulted_oracle", name, "rounds")] = _run(
            sim, lambda: sim.run_rounds(sim.init_state(), *b), mesh)
        out[("faulted_oracle", name, "step")] = _stepwise(sim, b, mesh)
    # tests/test_nemesis.py:312: stepwise (round by round), fused and
    # run_rounds under crash and loss
    b = staged(SCAN8, 12, 4, 2)
    sim = KafkaSim(8, 4, 64, max_sends=2, fault_plan=plan(SCAN8), **on)
    out[("faulted_scan", "step")] = _stepwise(sim, b, mesh, per_round=True)
    out[("faulted_scan", "fused")] = kstate(sim, sim.run_fused(
        sim.init_state(), *b))
    out[("faulted_scan", "rounds")] = kstate(sim, sim.run_rounds(
        sim.init_state(), *b))
    # :342: blocked, materialized and matmul, fused and stepwise
    b = staged(NEM16, 10, 4, 2)
    for name, kw in THREE_WAY.items():
        sim = KafkaSim(16, 4, 64, max_sends=2, fault_plan=plan(NEM16), **kw,
                       **on)
        out[("three_way", name, "fused")] = dict(
            _run(sim, lambda: sim.run_fused(sim.init_state(), *b), mesh),
            ub=sim._ub)
        out[("three_way", name, "step")] = _stepwise(sim, b, mesh)
    # the push resync on the same plan, blocked and materialized
    for ub in (1, "materialized"):
        sim = KafkaSim(16, 4, 64, max_sends=2, fault_plan=plan(NEM16),
                       resync_mode="push", union_block=ub, **on)
        out[("push", ub)] = _run(
            sim, lambda: sim.run_fused(sim.init_state(), *b), mesh)
    # tests/test_kvstore.py:280: the device KV's scripted dance, and the
    # host KV's (equal to it)
    for backend in ("host", "device"):
        sim = KafkaSim(8, 2, 32, max_sends=1, kv_backend=backend, **on)
        out[("drive_kafka", backend)] = drive_kafka(sim)
    # the device KV with kv_amnesia under a crash plan, round by round
    b = staged(AMNESIA16, 10, 8, 2)
    sim = KafkaSim(16, 8, 64, max_sends=2, fault_plan=plan(AMNESIA16),
                   kv_backend="device", kv_amnesia=True, **on)
    out["amnesia"] = _stepwise(sim, b, mesh, per_round=True)
    # tests/test_tpu_sim_programs.py:177: step by step, round by round
    sim = KafkaSim(8, 5, 64, max_sends=2, **on)
    st, rounds = sim.init_state(), []
    for sk, sv, cr in programs_steps():
        st = sim.step(st, sk, sv, cr)
        rounds.append(kstate(sim, st))
    out["programs_steps"] = rounds
    # :270: run_rounds against stepwise
    b = stepwise_batches()
    out[("run_rounds", "rounds")] = kstate(sim, sim.run_rounds(
        sim.init_state(), *b))
    out[("run_rounds", "step")] = _stepwise(sim, b, mesh)
    # :459: a KV window on the mesh
    blocked, sks, svs, crs = window()
    sim = KafkaSim(8, 3, 16, max_sends=2, kv_retries=3,
                   kv_sched=KVReach.from_numpy([0], [2], blocked), **on)
    out["kv_window"] = kstate(sim, sim.run_rounds(sim.init_state(), sks,
                                                  svs, crs))
    # :489: the commit-free path against explicit all -1 commits
    sks, svs, crs = commit_free_batches()
    sim = KafkaSim(8, 3, 16, max_sends=2, **on)
    out[("commit_free", "auto")] = _run(
        sim, lambda: sim.run_rounds(sim.init_state(), sks, svs), mesh)
    out[("commit_free", "explicit")] = kstate(sim, sim.run_rounds(
        sim.init_state(), sks, svs, crs))
    # the host reads on every rank, after the faulted scan's run
    b = staged(SCAN8, 12, 4, 2)
    sim = KafkaSim(8, 4, 64, max_sends=2, fault_plan=plan(SCAN8), **on)
    st = sim.run_fused(sim.init_state(), *b)
    nodes, keys, froms, sk = reads_queries(8, 4)
    offs, vals = sim.poll_batch(st, nodes, keys, froms)
    out["reads"] = {
        "poll": [sim.poll(st, i, k, 0) for i in range(8) for k in range(4)],
        "poll_batch": (offs, vals),
        "alloc_offsets": sim.alloc_offsets(st, sk),
        "list_committed": [sim.list_committed(st, i) for i in range(8)],
        "lin_kv": sim.lin_kv(st), "present_bool": sim.present_bool(st)}
    # unique ids and echo (tests/test_tpu_sim_programs.py:216, :231)
    ids = UniqueIdsSim(64, max_per_round=4, **on)
    st = ids.init_state()
    rng = np.random.default_rng(0)
    minted = []
    for _ in range(3):
        st, got = ids.step(st, rng.integers(0, 5, 64).astype(np.int32))
        minted.append(ids.format_ids(_full(mesh, got)))
    out["ids"] = {"formatted": minted, "t": st.t,
                  "minted": _full(mesh, st.minted).cpu().numpy()}
    echo = EchoSim(8, **on)
    payload = np.arange(32, dtype=np.int32).reshape(8, 4)
    before = _before(mesh)
    st, replies = echo.step(echo.init_state(), payload, payload % 3 == 0)
    calls = _calls(mesh, before)
    out["echo"] = {"replies": _full(mesh, replies).cpu().numpy(),
                   "t": st.t, "msgs": int(st.msgs), "calls": calls}
    return out


def kafka_world(mesh) -> dict:
    """Everything test_torch_mesh_kafka.py reads: the cases on the 4-rank
    mesh and on the 2-rank mesh of ranks 0 and 1, and the ``sims`` task's
    Kafka half on the 4-rank mesh."""
    from gossip_glomers_tpu_torch.parallel import dcn_worker

    out = {4: kafka_cases(mesh),
           "sims": dcn_worker._task_sims(mesh, mesh.device, ("kafka",))}
    m2 = _sub(mesh, 2)
    if m2 is not None:
        out[2] = kafka_cases(m2)
    mesh.agree(True)      # ranks 2 and 3 wait for the 2-rank cases
    return out
