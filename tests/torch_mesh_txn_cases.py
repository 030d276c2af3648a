"""Rank-side cases of tests/test_torch_mesh_txn.py: module-level
functions that a spawned rank of ``dcn_worker.spawn_world`` runs as
``fn(mesh)``, and that the tests also run in one process (``mesh=None``,
on the CPU).  One world runs every case on the whole 4-rank mesh and on a
2-rank mesh of ranks 0 and 1.  Inputs are made from seeds by the
functions and constants below, which the tests also use to build the JAX
package's runs; states come back as numpy, their node blocks gathered,
so every rank reports the global ones.  No JAX here: the ranks import
this module."""

import tempfile

import numpy as np

from torch_mesh_fault_cases import _before, _calls, _dev, _on, _sub
from gossip_glomers_tpu_torch.harness import nemesis as H
from gossip_glomers_tpu_torch.harness import serving as SV
from gossip_glomers_tpu_torch.harness import txn as HT
from gossip_glomers_tpu_torch.parallel.topology import (to_padded_neighbors,
                                                         tree)
from gossip_glomers_tpu_torch.tpu_sim import faults, kvstore
from gossip_glomers_tpu_torch.tpu_sim import provenance as PV
from gossip_glomers_tpu_torch.tpu_sim import structured as S
from gossip_glomers_tpu_torch.tpu_sim import telemetry as TM
from gossip_glomers_tpu_torch.tpu_sim import traffic as T
from gossip_glomers_tpu_torch.tpu_sim import txn as TX
from gossip_glomers_tpu_torch.tpu_sim.broadcast import (BroadcastSim,
                                                        make_inject)
from gossip_glomers_tpu_torch.tpu_sim.counter import CounterSim
from gossip_glomers_tpu_torch.tpu_sim.kafka import KafkaSim

# -- the inputs, shared with the JAX side -------------------------------------

#: tests/test_txn.py:83's spec and sim arguments (16 nodes, 8 keys)
TXN_SPEC = dict(n_nodes=16, seed=7, crash=((2, 4, (3,)),), loss_rate=0.2,
                loss_until=5)
TXN_KW = dict(txns_per_node=4, ops_per_txn=2, rate=0.5, until=10,
              workload_seed=3)
TXN_ROUNDS = 14
#: the three conditions of the reference's case: clean, under its plan,
#: and under the plan with kv_amnesia
TXN_WAYS = ("clean", "plan", "amnesia")
#: run_txn_nemesis's campaign: 16 nodes, 8 keys; with kv_amnesia the
#: owner of key 0 also crashes over [3, 6) (tests/test_txn.py:120-152)
NEM_TXN = dict(n_nodes=16, seed=3, crash=((3, 6, (4,)),), loss_rate=0.2,
               loss_until=6)
NEM_TXN_KW = dict(n_keys=8, until=12, max_recovery_rounds=48)
#: tests/test_traffic.py:147
TRAFFIC = dict(n_nodes=16, n_clients=16, ops_per_client=4, until=10,
               rate=0.35, seed=3)
#: tests/test_telemetry.py's traffic spec and its plan (:196)
TEL_TRAFFIC = dict(n_nodes=8, n_clients=8, ops_per_client=6, until=12,
                   rate=0.4, seed=1)
TEL_TRAFFIC_SPEC = dict(n_nodes=8, seed=5, crash=((3, 6, (2,)),),
                        loss_rate=0.1, loss_until=8)
#: tests/test_provenance.py:616 and tests/test_scenario.py:389
DELAY_SPEC = dict(n_nodes=32, seed=5, crash=((3, 6, (2,)),), loss_rate=0.1,
                  loss_until=8)
DELAY_TRAFFIC = dict(n_nodes=32, n_clients=8, ops_per_client=6, until=12,
                     rate=0.4, seed=1)
#: tests/test_scenario.py:419
EDGE_TRAFFIC = dict(n_nodes=32, n_clients=8, ops_per_client=4, until=10,
                    rate=0.5, seed=2)
#: the counter and Kafka nemesis runners under traffic, telemetry on
RUNNER_SPEC = dict(n_nodes=16, seed=9, crash=((2, 6, (1, 8)),),
                   loss_rate=0.2, loss_until=10)
RUNNER_TRAFFIC = dict(n_nodes=16, n_clients=16, ops_per_client=4, until=10,
                      rate=0.3, seed=4)


def full_spec(n: int, seed: int = 7) -> dict:
    """tests/test_telemetry.py's full_spec: crash, loss and dup."""
    return dict(n_nodes=n, seed=seed, crash=((2, 5, (1, n // 2)),),
                loss_rate=0.15, loss_until=8, dup_rate=0.1, dup_until=8)


def gather_delays(n: int) -> np.ndarray:
    """tests/test_provenance.py:616's per-edge delays on the 4-ary tree."""
    nbrs = to_padded_neighbors(tree(n, branching=4))
    rng = np.random.default_rng(0)
    return np.where(np.asarray(nbrs) >= 0, rng.integers(1, 4, nbrs.shape),
                    1).astype(np.int32)


def edge_rows(n: int) -> np.ndarray:
    """tests/test_scenario.py:419's (2, N) per-edge delay rows."""
    return np.random.default_rng(0).integers(1, 4, (2, n)).astype(np.int32)


# -- helpers -------------------------------------------------------------------


def _full(mesh, x):
    return x if mesh is None else mesh.all_gather(x)


def tstate(mesh, st) -> dict:
    """A txn state as numpy, the node blocks gathered."""
    out = {f: _full(mesh, getattr(st, f)).cpu().numpy()
           for f in ("arrived", "cur", "issue", "issue_round",
                     "commit_round", "op_ver", "op_val")}
    out.update(rows_vals=_full(mesh, st.rows.vals).cpu().numpy(),
               rows_vers=_full(mesh, st.rows.vers).cpu().numpy(),
               t=int(st.t), msgs=int(st.msgs))
    return out


def tracker(mesh, ts) -> dict:
    """A traffic tracker as numpy, the client blocks gathered."""
    out = {f: _full(mesh, getattr(ts, f)).cpu().numpy()
           for f in ("issued_k", "issue_round", "done_round", "op_aux")}
    out.update({f: int(getattr(ts, f)) for f in (
        "arrived", "deferred", "completed", "deferred_resizing")})
    return out


def ring(tel) -> dict:
    return {"ring": tel.ring.cpu().numpy(), "wrote": int(tel.wrote)}


def cstate(mesh, st) -> dict:
    return {"pending": _full(mesh, st.pending).cpu().numpy(),
            "cached": _full(mesh, st.cached).cpu().numpy(),
            "kv": int(st.kv), "t": int(st.t), "msgs": int(st.msgs)}


def kstate(mesh, st) -> dict:
    out = {f: _full(mesh, getattr(st, f)).cpu().numpy()
           for f in ("present", "local_committed", "origin_bits")}
    out.update(log_vals=st.log_vals.cpu().numpy(),
               kv_val=st.kv_val.cpu().numpy(), t=int(st.t),
               msgs=int(st.msgs))
    return out


def bstate(sim, st) -> dict:
    return {"received": sim.received_node_major(st), "t": int(st.t),
            "msgs": int(st.msgs)}


def _plan(kw: dict, mesh):
    return faults.NemesisSpec(**kw).compile(device=_dev(mesh))


def _drop_walls(res: dict) -> dict:
    """A runner's result without its wall clocks."""
    return {k: v for k, v in res.items()
            if k not in ("driven_s", "total_s", "ops_per_sec")}


# -- txn -----------------------------------------------------------------------


def txn_sim(way: str, mesh):
    plan = None if way == "clean" else _plan(TXN_SPEC, mesh)
    return TX.TxnSim(16, 8, fault_plan=plan, kv_amnesia=way == "amnesia",
                     **TXN_KW, **_on(mesh))


def txn_cases(mesh) -> dict:
    """tests/test_txn.py:83 three ways, each stepped round by round, then
    ``run`` and ``run_fused``; the census of a step; the host reads on
    every rank; ``run_txn_nemesis`` with and without ``kv_amnesia``."""
    out = {}
    for way in TXN_WAYS:
        sim = txn_sim(way, mesh)
        st, rounds = sim.init_state(), []
        for _ in range(TXN_ROUNDS):
            st = sim.step(st)
            rounds.append(tstate(mesh, st))
        out[(way, "step")] = rounds
        out[(way, "run")] = tstate(mesh, sim.run(sim.init_state(),
                                                 TXN_ROUNDS))
        before = _before(mesh)
        fused = sim.run_fused(sim.init_state(), TXN_ROUNDS)
        out[(way, "calls")] = _calls(mesh, before)
        out[(way, "fused")] = tstate(mesh, fused)
        out[(way, "history")] = TX.history_of(st, sim.ops, mesh)
        out[(way, "final")] = TX.final_registers(st, sim.layout, mesh)
        out[(way, "provenance")] = HT.txn_provenance_arrays(st, mesh)
    owner = int(kvstore.host_owner_of(np.zeros(1, np.int32), 16, 0)[0])
    spec = faults.NemesisSpec(**NEM_TXN)
    place = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    out["nemesis"] = HT.run_txn_nemesis(spec, **NEM_TXN_KW, **place)
    bad = faults.NemesisSpec(**dict(NEM_TXN, crash=((3, 6, (owner,)),)))
    with tempfile.TemporaryDirectory() as tmp:
        # every rank writes into its own directory, rank 0 alone a file
        res = HT.run_txn_nemesis(bad, kv_amnesia=True, observe_dir=tmp,
                                 **NEM_TXN_KW, **place)
        path = res.pop("flight_bundle", None)
        import os
        out["nemesis_amnesia"] = res
        # rank 0 writes the bundle (each rank has its own directory here)
        out["nemesis_amnesia_bundle"] = (
            None if path is None else os.path.basename(path))
        out["nemesis_amnesia_written"] = (
            None if mesh is not None and mesh.rank else
            path is not None and os.path.exists(path))
    out["owner"] = owner
    return out


# -- traffic and telemetry -------------------------------------------------------


def traffic_cases(mesh) -> dict:
    """tests/test_traffic.py:147; tests/test_telemetry.py's mesh_on
    cases (:82, :111, :140, :196); tests/test_provenance.py:616;
    tests/test_scenario.py:389 and :419; the counter and Kafka nemesis
    runners under traffic with telemetry; the host reads of a tracker on
    every rank.  Each driver's census too."""
    out = {}
    on = _on(mesh)
    # tests/test_traffic.py:147: the cas counter's tracker, 24 rounds
    spec = T.TrafficSpec(**TRAFFIC)
    sim = CounterSim(16, mode="cas", poll_every=2, **on)
    st, ts = sim.init_state(), sim.traffic_state(spec)
    before = _before(mesh)
    st, ts = sim.run_traffic(st, ts, spec, 24, donate=True)
    calls = _calls(mesh, before)
    out["counter_traffic"] = {"ts": tracker(mesh, ts),
                              "state": cstate(mesh, st),
                              "summary": T.latency_summary(ts, mesh),
                              "series": T.per_round_series(ts, 24, mesh),
                              "calls": calls}
    # tests/test_telemetry.py:82: the counter's observed driver
    n, rounds = 16, 12
    sim = CounterSim(n, mode="cas", poll_every=2,
                     fault_plan=_plan(full_spec(n), mesh), **on)
    deltas = np.arange(1, n + 1, dtype=np.int32)
    tsp = TM.TelemetrySpec("counter", rounds=rounds)
    before = _before(mesh)
    obs, tel = sim.run_observed(sim.add(sim.init_state(), deltas),
                                sim.telemetry_state(tsp), tsp, rounds,
                                donate=True)
    calls = _calls(mesh, before)
    s1, tel1 = sim.add(sim.init_state(), deltas), sim.telemetry_state(tsp)
    for _ in range(rounds):
        s1, tel1 = sim.run_observed(s1, tel1, tsp, 1)
    plain = sim.run_fused(sim.add(sim.init_state(), deltas), rounds)
    out["counter_observed"] = {
        "obs": cstate(mesh, obs), "plain": cstate(mesh, plain),
        "step": cstate(mesh, s1), "tel": ring(tel), "tel_step": ring(tel1),
        "calls": calls}
    # :111: broadcast, gather and structured (the nemesis bundle)
    n, nv, rounds = 32, 64, 10
    nbrs = to_padded_neighbors(tree(n, branching=4))
    for structured in (False, True):
        kw = dict(n_values=nv, sync_every=4, srv_ledger=False,
                  fault_plan=_plan(full_spec(n), mesh), **on)
        if structured:
            kw["exchange"] = S.make_exchange("tree", n, branching=4)
            kw["nemesis"] = S.make_nemesis(
                "tree", n, faults.NemesisSpec(**full_spec(n)),
                n_shards=None if mesh is None else mesh.size, branching=4,
                device=_dev(mesh))
        sim = BroadcastSim(nbrs, **kw)
        s0, _ = sim.stage(make_inject(n, nv))
        before = _before(mesh)
        plain = sim.run_staged_fixed(s0, rounds, donate=True)
        plain_calls = _calls(mesh, before)
        tsp = TM.TelemetrySpec("broadcast", rounds=rounds)
        s1, _ = sim.stage(make_inject(n, nv))
        before = _before(mesh)
        obs, tel = sim.run_observed(s1, sim.telemetry_state(tsp), tsp,
                                    rounds, donate=True)
        calls = _calls(mesh, before)
        out[("broadcast_observed", structured)] = {
            "obs": bstate(sim, obs), "plain": bstate(sim, plain),
            "tel": ring(tel), "calls": calls, "plain_calls": plain_calls}
    # :140: Kafka's observed driver over the nemesis runner's ops
    n, k, rounds = 16, 4, 12
    spec = faults.NemesisSpec(**full_spec(n))
    sks, svs, crs = H.stage_kafka_ops(spec, rounds, n_keys=k, max_sends=2,
                                      workload_seed=0)
    sim = KafkaSim(n, k, 64, max_sends=2, fault_plan=_plan(full_spec(n),
                                                           mesh),
                   resync_every=4, **on)
    plain = sim.run_fused(sim.init_state(), sks, svs, crs)
    tsp = TM.TelemetrySpec("kafka", rounds=rounds, series=(
        "live_nodes", "alloc_total", "present_bits", "present_bits_full",
        "msgs"))
    before = _before(mesh)
    obs, tel = sim.run_observed(sim.init_state(), sim.telemetry_state(tsp),
                                tsp, sks, svs, crs, donate=True)
    calls = _calls(mesh, before)
    out["kafka_observed"] = {"obs": kstate(mesh, obs),
                             "plain": kstate(mesh, plain), "tel": ring(tel),
                             "calls": calls}
    # :196: the counter's traffic with telemetry
    n = 8
    tspec = T.TrafficSpec(**TEL_TRAFFIC)
    sim = CounterSim(n, mode="cas", poll_every=2,
                     fault_plan=_plan(TEL_TRAFFIC_SPEC, mesh), **on)
    plain = sim.run_traffic(sim.init_state(), sim.traffic_state(tspec),
                            tspec, 16, donate=True)
    tsp = TM.TelemetrySpec("counter", rounds=16, traffic=True)
    before = _before(mesh)
    st, ts, tel = sim.run_traffic(
        sim.init_state(), sim.traffic_state(tspec), tspec, 16, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    calls = _calls(mesh, before)
    out["counter_traffic_tel"] = {
        "state": cstate(mesh, st), "ts": tracker(mesh, ts), "tel": ring(tel),
        "plain_state": cstate(mesh, plain[0]),
        "plain_ts": tracker(mesh, plain[1]), "calls": calls,
        "summary": T.latency_summary(ts, mesh)}
    # tests/test_provenance.py:616: the gather delays ring under a plan
    n, nv = 32, 256
    sim = BroadcastSim(to_padded_neighbors(tree(n, branching=4)),
                       n_values=nv, sync_every=4, srv_ledger=False,
                       delays=gather_delays(n),
                       fault_plan=_plan(DELAY_SPEC, mesh), **on)
    tspec = T.TrafficSpec(**DELAY_TRAFFIC)
    tsp = TM.TelemetrySpec("broadcast", rounds=30, traffic=True)
    before = _before(mesh)
    st, ts, tel = sim.run_traffic(
        sim.init_state(np.zeros((n, nv // 32), np.uint32)),
        sim.traffic_state(tspec), tspec, 30, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    calls = _calls(mesh, before)
    out["gather_delays_traffic"] = {
        "state": bstate(sim, st), "ts": tracker(mesh, ts), "tel": ring(tel),
        "summary": T.latency_summary(ts, mesh), "calls": calls}
    # Kafka's traffic driver with telemetry, blocked faulted union
    tspec = T.TrafficSpec(**RUNNER_TRAFFIC)
    sim = KafkaSim(16, 4, 64, max_sends=2, resync_every=2, union_block=2,
                   fault_plan=_plan(RUNNER_SPEC, mesh), **on)
    tsp = TM.TelemetrySpec("kafka", rounds=14, traffic=True)
    before = _before(mesh)
    st, ts, tel = sim.run_traffic(
        sim.init_state(), sim.traffic_state(tspec), tspec, 14, donate=True,
        tel=sim.telemetry_state(tsp), tel_spec=tsp)
    calls = _calls(mesh, before)
    out["kafka_traffic"] = {"state": kstate(mesh, st),
                            "ts": tracker(mesh, ts), "tel": ring(tel),
                            "calls": calls}
    # tests/test_scenario.py:389: the nemesis runner, dir_delays
    place = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    out["wm_delay_runner"] = _drop_walls(H.run_broadcast_nemesis(
        faults.NemesisSpec(**DELAY_SPEC), topology="tree",
        traffic=T.TrafficSpec(**DELAY_TRAFFIC), dir_delays=(2, 1),
        structured=True, telemetry=True, **place))
    # :419: serving on the edge-delayed structured tree
    kw = {"topology": "tree", "structured": True,
          "edge_delay_rows": edge_rows(32).tolist()}
    out["edge_serving"] = _drop_walls(SV.run_serving(
        "broadcast", T.TrafficSpec(**EDGE_TRAFFIC), sim_kw=dict(kw),
        series=True, telemetry=True, **place))
    # the counter and Kafka nemesis runners' traffic campaigns
    spec = faults.NemesisSpec(**RUNNER_SPEC)
    tspec = T.TrafficSpec(**RUNNER_TRAFFIC)
    out["counter_runner"] = _drop_walls(H.run_counter_nemesis(
        spec, traffic=tspec, telemetry=True, **place))
    out["kafka_runner"] = _drop_walls(H.run_kafka_nemesis(
        spec, traffic=tspec, telemetry=True, n_keys=4, capacity=64,
        **place))
    # the quiescent campaigns on the mesh (provenance off), telemetry on
    out["counter_campaign"] = H.run_counter_nemesis(spec, telemetry=True,
                                                    **place)
    out["kafka_campaign"] = H.run_kafka_nemesis(spec, telemetry=True,
                                                **place)
    out["broadcast_campaign"] = H.run_broadcast_nemesis(
        faults.NemesisSpec(**DELAY_SPEC), topology="tree", telemetry=True,
        **place)
    return out


def refusal_cases(mesh) -> dict:
    """What raises on a mesh, as (class name, message), and what runs
    there (since the provenance and scenario-batch slice, and the
    ``dcn_mode`` probes since the two-axis slice), as ("ran", its
    result)."""
    out = {}

    def catch(name, fn):
        try:
            out[name] = ("ran", fn())
        except Exception as e:        # the class and text are the result
            out[name] = (type(e).__name__, str(e))

    def whole(prov):
        if mesh is not None:
            prov = type(prov)(*(mesh.all_gather(x) for x in prov))
        return PV.arrays_of(prov)

    spec = faults.NemesisSpec(**RUNNER_SPEC)
    nbrs = to_padded_neighbors(tree(16, branching=4))
    on = _on(mesh)
    place = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    sim = BroadcastSim(nbrs, n_values=16, srv_ledger=False, **on)
    psp = PV.ProvenanceSpec("broadcast")
    inj = make_inject(16, 16)

    def broadcast_prov():
        st, prov = sim.run_observed(sim.init_state(inj), None, None, 2,
                                    prov=sim.provenance_state(psp, inj),
                                    prov_spec=psp)
        return {"state": bstate(sim, st), "prov": whole(prov)}

    catch("broadcast_prov", broadcast_prov)
    csim = CounterSim(16, **on)

    def counter_prov():
        cpsp = PV.ProvenanceSpec("counter")
        st, prov = csim.run_observed(
            csim.add(csim.init_state(), np.arange(1, 17)), None, None, 4,
            prov=csim.provenance_state(cpsp), prov_spec=cpsp)
        return {"state": cstate(mesh, st), "prov": whole(prov)}

    catch("counter_prov", counter_prov)
    for name in ("broadcast", "counter", "kafka"):
        catch(f"{name}_runner_prov", lambda name=name: getattr(
            H, f"run_{name}_nemesis")(spec, provenance=True, **place))
        catch(f"{name}_runner_dcn", lambda name=name: getattr(
            H, f"run_{name}_nemesis")(spec, dcn_mode="sync", **place))
    def txn_dcn():
        tsim = TX.TxnSim(16, 8, dcn_mode="sync", **on)
        return tstate(mesh, tsim.run(tsim.init_state(), 4))

    catch("txn_dcn", txn_dcn)
    catch("txn_frontier", lambda: HT.run_txn_frontier(
        [0.5], [spec], **place))
    return out


def txn_world(mesh) -> dict:
    """Everything test_torch_mesh_txn.py reads: the cases on the 4-rank
    mesh and the txn cases on the 2-rank mesh of ranks 0 and 1."""
    out = {4: {"txn": txn_cases(mesh), "traffic": traffic_cases(mesh),
               "refusals": refusal_cases(mesh)}}
    m2 = _sub(mesh, 2)
    if m2 is not None:
        out[2] = {"txn": txn_cases(m2), "traffic": traffic_cases(m2)}
    mesh.agree(True)      # ranks 2 and 3 wait for the 2-rank cases
    return out
