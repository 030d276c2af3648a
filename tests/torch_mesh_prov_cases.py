"""Rank-side cases of tests/test_torch_mesh_prov.py: module-level
functions that a spawned rank of ``dcn_worker.spawn_world`` runs as
``fn(mesh, ...)``, and that the tests also run in one process
(``mesh=None``, on the CPU).  One world runs every case on the whole
4-rank mesh and on a 2-rank mesh of ranks 0 and 1.  The records come
back as numpy, the node-split stamps gathered, so every rank reports the
whole record.  No JAX here: the ranks import this module."""

import os
import tempfile

import numpy as np

from torch_mesh_fault_cases import _before, _calls, _dev, _on, _sub
from torch_mesh_txn_cases import (DELAY_SPEC, RUNNER_SPEC, _drop_walls,
                                  bstate, cstate, full_spec, gather_delays,
                                  kstate)
from gossip_glomers_tpu_torch.harness import nemesis as H
from gossip_glomers_tpu_torch.harness import observe
from gossip_glomers_tpu_torch.harness.checkers import check_provenance
from gossip_glomers_tpu_torch.parallel.topology import (to_padded_neighbors,
                                                         tree)
from gossip_glomers_tpu_torch.tpu_sim import faults
from gossip_glomers_tpu_torch.tpu_sim import provenance as PV
from gossip_glomers_tpu_torch.tpu_sim.broadcast import (BroadcastSim,
                                                        Partitions,
                                                        make_inject)
from gossip_glomers_tpu_torch.tpu_sim.counter import CounterSim
from gossip_glomers_tpu_torch.tpu_sim.engine import host_unpack_bits
from gossip_glomers_tpu_torch.tpu_sim.kafka import KafkaSim

# -- the inputs, shared with the JAX side -------------------------------------

#: tests/test_provenance.py:101 (one hop under the full plan), :133 (the
#: per-edge delays ring: delays 1-3, three classes) and a plan-free one
#: hop under a partition window
BROADCAST_WAYS = ("plan", "delays", "window")
BROADCAST_N, BROADCAST_V = 32, 64
BROADCAST_ROUNDS = {"plan": 12, "delays": 16, "window": 10}
#: the window's halves: even and odd nodes, cut over rounds [1, 6)
WINDOW = (1, 6)
#: tests/test_provenance.py:167 and :196
COUNTER_N, COUNTER_ROUNDS = 16, 16
KAFKA_N, KAFKA_K, KAFKA_ROUNDS = 16, 4, 12
#: Kafka's witness rows: node 0 (rank 0) and node 9, which lies in rank
#: 2's block of 4 ranks (rank 1's of 2)
WITNESSES = (0, 9)
#: the nemesis runners' campaigns with provenance on: tests/test_torch_
#: mesh_txn.py's campaigns (which certify), and a failing one (the full
#: plan, no recovery budget) whose bundle is replayed
RUNNER_BROADCAST = DELAY_SPEC
RUNNER_SMALL = RUNNER_SPEC
FAILED_SPEC = dict(full_spec(32), seed=3)


def window_group(n: int) -> np.ndarray:
    return (np.arange(n) % 2).astype(np.int8)[None, :]


def broadcast_kw(way: str, n: int = BROADCAST_N) -> dict:
    """The sim's keywords of a way, without its plan and placement."""
    kw = dict(n_values=BROADCAST_V, sync_every=4, srv_ledger=False)
    if way == "delays":
        kw["delays"] = gather_delays(n)
    return kw


def broadcast_spec(way: str, n: int = BROADCAST_N) -> dict | None:
    return {"plan": full_spec(n), "delays": DELAY_SPEC,
            "window": None}[way]


# -- helpers -------------------------------------------------------------------


def parrays(mesh, prov, split: bool = True) -> dict:
    """A record as numpy arrays, its node-split stamps gathered."""
    if mesh is not None and split:
        prov = type(prov)(*(mesh.all_gather(x) for x in prov))
    return PV.arrays_of(prov)


def _place(mesh) -> dict:
    return {"mesh": mesh} if mesh is not None else {"device": "cpu"}


# -- the observed drivers ------------------------------------------------------


def broadcast_case(mesh, way: str) -> dict:
    """The gather path's stamps one hop under the full plan, under the
    per-edge delays ring and under a partition window alone: the plain
    fixed trip, the observed trip (its census), the stepped one, and the
    record certified against the fault model."""
    n, nv, rounds = BROADCAST_N, BROADCAST_V, BROADCAST_ROUNDS[way]
    nbrs = to_padded_neighbors(tree(n, branching=4))
    kw = broadcast_kw(way)
    spec = broadcast_spec(way)
    if spec is not None:
        kw["fault_plan"] = faults.NemesisSpec(**spec).compile(
            device=_dev(mesh))
    parts = None
    if way == "window":
        parts = Partitions.from_numpy([WINDOW[0]], [WINDOW[1]],
                                      window_group(n))
        kw["parts"] = parts.to(_dev(mesh))
    sim = BroadcastSim(nbrs, **kw, **_on(mesh))
    inj = make_inject(n, nv)
    psp = PV.ProvenanceSpec("broadcast")
    s0, _ = sim.stage(inj)
    before = _before(mesh)
    plain = sim.run_staged_fixed(s0, rounds, donate=True)
    plain_calls = _calls(mesh, before)
    s1, _ = sim.stage(inj)
    before = _before(mesh)
    obs, prov = sim.run_observed(
        s1, None, None, rounds, donate=True,
        prov=sim.provenance_state(psp, inj), prov_spec=psp)
    calls = _calls(mesh, before)
    s2, _ = sim.stage(inj)
    p2 = sim.provenance_state(psp, inj)
    for _ in range(rounds):
        s2, p2 = sim.run_observed(s2, None, None, 1, prov=p2, prov_spec=psp)
    arrs = parrays(mesh, prov)
    rec = sim.received_node_major(obs)
    ok, det = check_provenance(
        "broadcast", arrs,
        spec=None if spec is None else faults.NemesisSpec(**spec),
        nbrs=nbrs, received=host_unpack_bits(rec, nv),
        msgs_total=int(obs.msgs),
        parts=None if parts is None else parts.to_meta(),
        delays=kw.get("delays"))
    return {"plain": bstate(sim, plain), "obs": bstate(sim, obs),
            "step": bstate(sim, s2), "prov": arrs,
            "prov_step": parrays(mesh, p2), "check_ok": ok,
            "problems": det["problems"], "calls": calls,
            "plain_calls": plain_calls}


def counter_case(mesh) -> dict:
    """The counter's flush / KV / visibility stamps under the full plan;
    each rank's own least cache a round (which differ across ranks: the
    visibility stamp reads the least over the mesh)."""
    n, rounds = COUNTER_N, COUNTER_ROUNDS
    spec = full_spec(n)
    sim = CounterSim(n, mode="cas", poll_every=2,
                     fault_plan=faults.NemesisSpec(**spec).compile(
                         device=_dev(mesh)), **_on(mesh))
    deltas = np.arange(1, n + 1, dtype=np.int32)
    psp = PV.ProvenanceSpec("counter")
    before = _before(mesh)
    plain = sim.run_fused(sim.add(sim.init_state(), deltas), rounds)
    plain_calls = _calls(mesh, before)
    before = _before(mesh)
    obs, prov = sim.run_observed(
        sim.add(sim.init_state(), deltas), None, None, rounds, donate=True,
        prov=sim.provenance_state(psp), prov_spec=psp)
    calls = _calls(mesh, before)
    s2, p2 = sim.add(sim.init_state(), deltas), sim.provenance_state(psp)
    mins = []
    for _ in range(rounds):
        s2, p2 = sim.run_observed(s2, None, None, 1, prov=p2, prov_spec=psp)
        low = s2.cached.min().reshape(1)
        mins.append((low if mesh is None
                     else mesh.all_gather(low)).cpu().numpy().tolist())
    arrs = parrays(mesh, prov)
    ok, det = check_provenance("counter", arrs,
                               spec=faults.NemesisSpec(**spec),
                               final_kv=sim.kv_value(obs))
    return {"plain": cstate(mesh, plain), "obs": cstate(mesh, obs),
            "step": cstate(mesh, s2), "prov": arrs,
            "prov_step": parrays(mesh, p2), "check_ok": ok,
            "problems": det["problems"], "calls": calls,
            "plain_calls": plain_calls, "rank_mins": mins}


def kafka_case(mesh, witness: int) -> dict:
    """Kafka's allocation, origin and witness-presence stamps under the
    full plan (the nemesis runner's staged ops), at a witness row."""
    n, k, rounds = KAFKA_N, KAFKA_K, KAFKA_ROUNDS
    spec = faults.NemesisSpec(**full_spec(n))
    sks, svs, crs = H.stage_kafka_ops(spec, rounds, n_keys=k, max_sends=2,
                                      workload_seed=0)
    sim = KafkaSim(n, k, 64, max_sends=2, resync_every=4,
                   fault_plan=spec.compile(device=_dev(mesh)), **_on(mesh))
    psp = PV.ProvenanceSpec("kafka", witness=witness)
    before = _before(mesh)
    plain = sim.run_fused(sim.init_state(), sks, svs, crs)
    plain_calls = _calls(mesh, before)
    before = _before(mesh)
    obs, prov = sim.run_observed(sim.init_state(), None, None, sks, svs,
                                 crs, donate=True,
                                 prov=sim.provenance_state(psp),
                                 prov_spec=psp)
    calls = _calls(mesh, before)
    arrs = parrays(mesh, prov, split=False)
    ok, det = check_provenance("kafka", arrs, spec=spec, n_nodes=n,
                               resync_every=4, resync_mode="pull",
                               witness=witness)
    return {"plain": kstate(mesh, plain), "obs": kstate(mesh, obs),
            "prov": arrs, "check_ok": ok, "problems": det["problems"],
            "calls": calls, "plain_calls": plain_calls}


# -- the runners and the replay ------------------------------------------------


def runner_cases(mesh) -> dict:
    """The three nemesis runners with provenance (and telemetry) on, and
    a failed broadcast campaign's bundle (no recovery budget), which rank
    0 writes and every rank then replays."""
    place = _place(mesh)
    out = {}
    out["broadcast"] = H.run_broadcast_nemesis(
        faults.NemesisSpec(**RUNNER_BROADCAST), topology="tree",
        provenance=True, telemetry=True, **place)
    out["broadcast_delays"] = H.run_broadcast_nemesis(
        faults.NemesisSpec(**DELAY_SPEC), topology="tree",
        delays=gather_delays(32), provenance=True, **place)
    out["counter"] = H.run_counter_nemesis(
        faults.NemesisSpec(**RUNNER_SMALL), provenance=True, telemetry=True,
        **place)
    out["kafka"] = H.run_kafka_nemesis(
        faults.NemesisSpec(**RUNNER_SMALL),
        provenance=PV.ProvenanceSpec("kafka", witness=WITNESSES[1]),
        telemetry=True, **place)
    with tempfile.TemporaryDirectory() as tmp:
        # every rank has its own directory: rank 0 alone writes a file
        res = H.run_broadcast_nemesis(
            faults.NemesisSpec(**FAILED_SPEC), topology="tree",
            provenance=True, telemetry=True, max_recovery_rounds=0,
            observe_dir=tmp, **place)
        path = res.pop("flight_bundle")
        out["failed"] = res
        out["failed_bundle"] = os.path.basename(path)
        out["failed_written"] = os.path.exists(path)
        if mesh is not None:
            # the ranks replay rank 0's file
            bundle = mesh.broadcast_object(
                observe.load_bundle(path) if mesh.rank == 0 else None)
        else:
            bundle = observe.load_bundle(path)
        out["failed_replay"] = observe.replay_bundle(bundle, **place)
    return out


def replay_cases(mesh, bundles: dict) -> dict:
    """``replay_bundle`` of the bundles the parent wrote (either package,
    provenance on and off), and a bundle naming a ``dcn_mode``, which
    replays in that mode."""
    place = _place(mesh)
    out = {name: _drop_walls(observe.replay_bundle(path, **place))
           for name, path in sorted(bundles.items())}
    bad = observe.load_bundle(bundles[sorted(bundles)[0]])
    bad = dict(bad, runner_kw=dict(bad.get("runner_kw") or {},
                                   dcn_mode="sync"))
    out["dcn_mode"] = _drop_walls(observe.replay_bundle(bad, **place))
    return out


def prov_cases(mesh, bundles: dict, runners: bool = True) -> dict:
    out = {("broadcast", way): broadcast_case(mesh, way)
           for way in BROADCAST_WAYS}
    out["counter"] = counter_case(mesh)
    for w in WITNESSES:
        out[("kafka", w)] = kafka_case(mesh, w)
    if runners:
        out["runners"] = runner_cases(mesh)
        out["replays"] = replay_cases(mesh, bundles)
    return out


def prov_world(mesh, bundles: dict) -> dict:
    """Everything test_torch_mesh_prov.py reads: every case on the 4-rank
    mesh, the observed drivers' cases on the 2-rank mesh of ranks 0 and
    1."""
    out = {4: prov_cases(mesh, bundles)}
    m2 = _sub(mesh, 2)
    if m2 is not None:
        out[2] = prov_cases(m2, bundles, runners=False)
    mesh.agree(True)      # ranks 2 and 3 wait for the 2-rank cases
    return out
