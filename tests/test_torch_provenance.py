"""Causal provenance on PyTorch (gossip_glomers_tpu_torch/tpu_sim/
provenance.py, ``kernels.prov_attribute``, the sims' ``run_observed``,
harness/checkers.py ``check_provenance`` and harness/observe.py) against
the JAX reference on the CPU:

- ``prov_attribute_plain`` equals the reference's ``_prov_attribute``
  (broadcast.py:317-342) over the reference's term functions on seeded
  inputs, in every mode the gather round wires: plain, partition
  windows, a plan, a plan with dup, per-edge delays, delays under a plan;
- ``flood_step(prov=)`` and each sim's ``run_observed`` equal the
  reference's at every round (state, telemetry ring, stamps), and
  observation on equals observation off bit for bit;
- the forged records of tests/test_provenance.py fail the port's
  certifier; the dissemination tree, the divergence round, the env knob,
  the runner refusals and the record's carry across the two packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import nemesis as JNM
from gossip_glomers_tpu.harness import observe as JOB
from gossip_glomers_tpu.parallel.topology import (random_regular,
                                                  to_padded_neighbors, tree)
from gossip_glomers_tpu.tpu_sim import broadcast as JB
from gossip_glomers_tpu.tpu_sim import provenance as JPV
from gossip_glomers_tpu.tpu_sim import structured as JS
from gossip_glomers_tpu.tpu_sim import telemetry as JTM
from gossip_glomers_tpu.tpu_sim.counter import CounterSim as JC
from gossip_glomers_tpu.tpu_sim.faults import NemesisSpec as JN
from gossip_glomers_tpu.tpu_sim.kafka import KafkaSim as JK
from gossip_glomers_tpu_torch.harness import nemesis as PNM
from gossip_glomers_tpu_torch.harness import observe as POB
from gossip_glomers_tpu_torch.harness.checkers import (
    check_provenance, check_recovery, check_telemetry,
    provenance_divergence_round, series_divergence_round)
from gossip_glomers_tpu_torch.tpu_sim import broadcast as PB
from gossip_glomers_tpu_torch.tpu_sim import kernels
from gossip_glomers_tpu_torch.tpu_sim import provenance as PPV
from gossip_glomers_tpu_torch.tpu_sim import structured as PS
from gossip_glomers_tpu_torch.tpu_sim import telemetry as PTM
from gossip_glomers_tpu_torch.tpu_sim.counter import CounterSim as PC
from gossip_glomers_tpu_torch.tpu_sim.engine import host_unpack_bits
from gossip_glomers_tpu_torch.tpu_sim.faults import NemesisSpec as PN
from gossip_glomers_tpu_torch.tpu_sim.kafka import KafkaSim as PK


def same(a, b) -> bool:
    """A JAX leaf equals a port leaf (uint32 words through their int32
    view, counters as values)."""
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.uint32 and b.dtype == np.int32:
        a = a.view(np.int32)
    return a.shape == b.shape and bool((a.astype(np.int64)
                                        == b.astype(np.int64)).all())


def same_prov(j, p) -> bool:
    return all(same(x, y) for x, y in zip(j, p))


def full_kw(n, seed=7):
    """crash + loss + dup: the full fault model."""
    return dict(n_nodes=n, seed=seed, crash=((2, 5, (1, n // 2)),),
                loss_rate=0.15, loss_until=8, dup_rate=0.1, dup_until=8)


# -- the kernel's plain version against the reference's attribution ------

ATTR_MODES = ("plain", "partitions", "plan", "plan_dup", "delays",
              "delays_plan")


def _attr_inputs(mode: str, seed: int):
    """Seeded inputs of one round's attribution: the round's ``new``
    bits (a subset of the inbox), the stamps so far, the table (padded),
    and the mode's per-edge data."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 70))
    nv = int(rng.integers(1, 97))             # ragged V
    w = (nv + 31) // 32 + int(rng.integers(0, 2))
    d = int(rng.integers(1, 7))
    nbrs = rng.integers(0, n, (n, d)).astype(np.int32)
    nbrs[rng.random((n, d)) < 0.3] = -1      # padded directions
    words = lambda *s: rng.integers(0, 1 << 32, s,                # noqa
                                    dtype=np.uint64).astype(np.uint32)
    arrival = np.where(rng.random((n, nv)) < 0.4,
                       rng.integers(0, 6, (n, nv)), -1).astype(np.int32)
    parent = np.where(arrival > 0, rng.integers(-1, n, (n, nv)),
                      -1).astype(np.int32)
    inp = dict(n=n, nv=nv, w=w, nbrs=nbrs, arrival=arrival, parent=parent,
               t_next=int(rng.integers(1, 9)))
    valid = nbrs >= 0
    if mode.startswith("delays"):
        ring = int(rng.integers(1, 5))
        history = words(ring, n, w)
        delays = np.where(valid, rng.integers(1, ring + 1, (n, d)), 1)
        t = int(rng.integers(0, 2 * ring))
        classes = {}
        for v in range(1, ring + 1):
            live = valid & (delays == v) & (rng.random((n, d)) < 0.8)
            if t - (v - 1) >= 0:
                classes[v] = ((t - (v - 1)) % ring, live)
        up = (rng.random(n) < 0.8) if mode == "delays_plan" else None
        inp.update(history=history, delays=delays, classes=classes, up=up)
    else:
        payload = words(n, w)
        live = valid & (rng.random((n, d)) < 0.8)
        flags = None
        if mode == "partitions":
            flags = live.astype(np.uint8) * kernels.FLAG_DEL
        elif mode.startswith("plan"):
            dele = live & (rng.random((n, d)) < 0.8)
            flags = (live * kernels.FLAG_SEND + dele * kernels.FLAG_DEL
                     ).astype(np.uint8)
            if mode == "plan_dup":
                flags += ((dele & (rng.random((n, d)) < 0.4))
                          * kernels.FLAG_DUP).astype(np.uint8)
        inp.update(payload=payload, flags=flags,
                   dup=words(n, w) if mode == "plan_dup" else None)
    # the round's new bits: some of what the terms deliver, none past V
    inbox = np.zeros((n, w), np.uint32)
    for dd in range(d):
        inbox |= np.asarray(_ref_term(inp, dd))
    mask = host_unpack_bits(np.full((1, w), 0xFFFFFFFF, np.uint32))[0]
    mask[nv:] = False
    keep = np.packbits(mask.reshape(w, 32)[:, ::-1], axis=1).view(
        ">u4").reshape(w).astype(np.uint32)
    inp["new"] = inbox & words(n, w) & keep[None, :]
    return inp


def _ref_term(inp: dict, d: int):
    """Direction ``d``'s delivered words as the reference's term
    functions form them (broadcast.py:586-642)."""
    nbrs = jnp.asarray(inp["nbrs"])
    idx = nbrs[:, d]
    if "history" in inp:
        t_ = None
        for v, (slot, live) in inp["classes"].items():
            ok = jnp.asarray(live[:, d])
            sl = jnp.asarray(inp["history"][slot])
            rows = sl[jnp.clip(idx, 0, sl.shape[0] - 1)]
            one = jnp.where(ok[:, None], rows, jnp.uint32(0))
            t_ = one if t_ is None else t_ | one
        if t_ is None:
            t_ = jnp.zeros((inp["n"], inp["w"]), jnp.uint32)
        if inp["up"] is not None:
            t_ = jnp.where(jnp.asarray(inp["up"])[:, None], t_,
                           jnp.uint32(0))
        return t_
    pay = jnp.asarray(inp["payload"])
    flags = inp["flags"]
    ok = (idx >= 0) if flags is None else jnp.asarray(
        (flags[:, d] & kernels.FLAG_DEL) != 0)
    t_ = jnp.where(ok[:, None], pay[jnp.clip(idx, 0, pay.shape[0] - 1)],
                   jnp.uint32(0))
    if inp["dup"] is not None:
        okd = jnp.asarray((flags[:, d] & kernels.FLAG_DUP) != 0)
        dup = jnp.asarray(inp["dup"])
        t_ = t_ | jnp.where(okd[:, None],
                            dup[jnp.clip(idx, 0, dup.shape[0] - 1)],
                            jnp.uint32(0))
    return t_


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mode", ATTR_MODES)
def test_prov_attribute_plain_matches_reference(mode, seed):
    inp = _attr_inputs(mode, 97 * seed + ATTR_MODES.index(mode))
    prov = JPV.BroadcastProv(jnp.asarray(inp["arrival"]),
                             jnp.asarray(inp["parent"]))
    want = JB._prov_attribute(prov, jnp.asarray(inp["new"]),
                              jnp.asarray(inp["nbrs"]),
                              lambda d: _ref_term(inp, d), inp["t_next"])
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(  # noqa
        np.int32))
    nbrs = torch.from_numpy(inp["nbrs"])
    if "history" in inp:
        terms = [(slot, torch.from_numpy(live))
                 for slot, live in inp["classes"].values()]
        up = None if inp["up"] is None else torch.from_numpy(inp["up"])
        edges = dict(slots=PB._slot_table(terms, nbrs.shape, up, "cpu"))
        src = i32(inp["history"])
    else:
        edges = dict(flags=None if inp["flags"] is None
                     else torch.from_numpy(inp["flags"]),
                     dup=None if inp["dup"] is None else i32(inp["dup"]))
        src = i32(inp["payload"])
    arr = torch.from_numpy(inp["arrival"].copy())
    par = torch.from_numpy(inp["parent"].copy())
    got = kernels.prov_attribute_plain(i32(inp["new"]), src, nbrs, arr, par,
                                       t_next=inp["t_next"], **edges)
    assert same(want.arrival, got[0]) and same(want.parent, got[1])
    # the wrapper on CPU tensors: the same stamps, in place
    kernels.prov_attribute(i32(inp["new"]), src, nbrs, arr, par,
                           t_next=inp["t_next"], **edges)
    assert torch.equal(arr, got[0]) and torch.equal(par, got[1])
    assert kernels.LAUNCHES["prov_attribute"] == 0   # CPU calls count none


def test_prov_attribute_first_direction_and_ragged_tail():
    # a bit two directions carry goes to the first; a padded direction
    # keeps its place; bits past V write nothing; a stamped cell stays;
    # every fresh new bit gets its arrival
    nbrs = torch.tensor([[-1, 2, 1], [0, -1, -1], [1, 0, -1]],
                        dtype=torch.int32)
    src = torch.tensor([[0b0110], [0b0011], [0b0101]], dtype=torch.int32)
    new = torch.tensor([[0b0111], [0b0110], [0b1111]], dtype=torch.int32)
    arr = torch.full((3, 3), -1, dtype=torch.int32)
    arr[2, 1] = 4
    par = torch.full((3, 3), -1, dtype=torch.int32)
    kernels.prov_attribute(new, src, nbrs, arr, par, t_next=7)
    assert arr.tolist() == [[7, 7, 7], [-1, 7, 7], [7, 4, 7]]
    # node 0: bits 0, 2 from node 2 (first), bit 1 from node 1; node 1:
    # bits 1, 2 from node 0; node 2: bit 0 from node 1, bit 2 from node 0
    assert par.tolist() == [[2, 1, 2], [-1, 0, 0], [1, -1, 0]]
    with pytest.raises(ValueError, match="V <= 32 W"):
        kernels.prov_attribute(new, src, nbrs, torch.zeros(3, 33).int(),
                               torch.zeros(3, 33).int(), t_next=1)
    with pytest.raises(ValueError, match="slots"):
        kernels.prov_attribute(new, src[None], nbrs, arr, par, t_next=1,
                               slots=torch.zeros(3, 3, dtype=torch.int8),
                               flags=torch.zeros(3, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="flag bytes"):
        kernels.prov_attribute(new, src, nbrs, arr, par, t_next=1, dup=src)


# -- the gather round and the observed drivers ---------------------------

ROUND_MODES = ("plain", "partitions", "plan", "plan_dup", "delays",
               "delays_plan")


def _broadcast_pair(mode: str, n: int = 32, nv: int = 45):
    nbrs = to_padded_neighbors(tree(n, branching=4)) if n % 2 \
        else random_regular(n, 4, seed=3)
    kw = dict(n_values=nv, sync_every=4, srv_ledger=False)
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if mode == "partitions":
        group = np.random.default_rng(4).integers(0, 2, (1, n)).astype(
            np.int8)
        jkw["parts"] = JB.Partitions(jnp.asarray([2], jnp.int32),
                                     jnp.asarray([7], jnp.int32),
                                     jnp.asarray(group))
        pkw["parts"] = PB.Partitions.from_numpy([2], [7], group)
    if mode.startswith("delays"):
        d = np.where(nbrs >= 0, np.random.default_rng(0).integers(
            1, 4, nbrs.shape), 1).astype(np.int32)
        jkw["delays"] = pkw["delays"] = d
    if mode in ("plan", "plan_dup", "delays_plan"):
        spec = full_kw(n)
        if mode != "plan_dup":
            spec.update(dup_rate=0.0, dup_until=None)
        jkw["fault_plan"] = JN(**spec).compile()
        pkw["fault_plan"] = PN(**spec).compile(device="cpu")
    return JB.BroadcastSim(nbrs, **jkw), PB.BroadcastSim(nbrs, **pkw)


@pytest.mark.parametrize("mode", ROUND_MODES)
def test_broadcast_run_observed_matches_reference_every_round(mode):
    js, ps = _broadcast_pair(mode)
    inj = JB.make_inject(32, 45)
    jsp, psp = JPV.ProvenanceSpec("broadcast"), PPV.ProvenanceSpec(
        "broadcast")
    jt, pt = JTM.TelemetrySpec("broadcast", 14), PTM.TelemetrySpec(
        "broadcast", 14)
    jst, _ = js.stage(inj)
    pst = ps.init_state(inj)
    jtel, ptel = js.telemetry_state(jt), ps.telemetry_state(pt)
    jpr, ppr = js.provenance_state(jsp, inj), ps.provenance_state(psp, inj)
    assert same_prov(jpr, ppr)
    for _ in range(14):
        jst, jtel, jpr = js.run_observed(jst, jtel, jt, 1, prov=jpr,
                                         prov_spec=jsp)
        pst, ptel, ppr = ps.run_observed(pst, ptel, pt, 1, prov=ppr,
                                         prov_spec=psp)
        assert same(jst.received, pst.received)
        assert int(jst.msgs) == int(pst.msgs) and int(jst.t) == pst.t
        assert same(jtel.ring, ptel.ring) and same_prov(jpr, ppr)
    # the donated full trip records the same, and equals the plain run
    pst2, ppr2 = ps.run_observed(ps.init_state(inj), None, None, 14,
                                 donate=True,
                                 prov=ps.provenance_state(psp, inj),
                                 prov_spec=psp)
    plain = ps.run_staged_fixed(ps.init_state(inj), 14)
    assert torch.equal(pst2.received, plain.received)
    assert torch.equal(pst2.msgs, plain.msgs) and pst2.t == plain.t
    assert all(torch.equal(a, b) for a, b in zip(ppr2, ppr))
    ok, det = check_provenance(
        "broadcast", PPV.arrays_of(ppr2),
        spec=(None if ps.fault_plan is None else PN(**full_kw(32))),
        nbrs=ps.nbrs.numpy(), received=host_unpack_bits(
            ps.received_node_major(pst2), 45),
        msgs_total=int(pst2.msgs),
        parts=None if not ps.parts.n_windows else ps.parts.to_meta(),
        delays=None if ps._classes is None else
        np.asarray(_broadcast_pair(mode)[0].delays))
    if mode in ("plain", "partitions", "delays"):
        assert ok, det["problems"]
    assert det["n_tree_edges"] > 0


@pytest.mark.parametrize("mode", ROUND_MODES)
def test_flood_step_with_prov_matches_reference(mode):
    js, ps = _broadcast_pair(mode, n=24, nv=33)
    inj = JB.make_inject(24, 33)
    jst, _ = js.stage(inj)
    jpr = js.provenance_state(JPV.ProvenanceSpec("broadcast"), inj)
    pst = ps.init_state(inj)
    ppr = ps.provenance_state(PPV.ProvenanceSpec("broadcast"), inj)
    delays = None if ps._classes is None else np.array(js.delays)
    for _ in range(10):
        jst, jpr = JB.flood_step(
            jst, nbrs=js.nbrs, nbr_mask=js.nbr_mask, parts=js.parts,
            sync_every=4, plan=js.fault_plan, dup_on=js._fp_dup,
            delays=None if delays is None else jnp.asarray(delays),
            prov=jpr)
        # union_block is ignored under provenance, as in the reference
        pst, ppr = PB.flood_step(
            pst, nbrs=ps.nbrs, nbr_mask=ps.nbr_mask, parts=ps.parts,
            sync_every=4, plan=ps.fault_plan, dup_on=ps._fp_dup,
            delays=None if delays is None else torch.from_numpy(delays),
            union_block=None if delays is not None else 8, prov=ppr)
        assert same(jst.received, pst.received) and same_prov(jpr, ppr)
        assert int(jst.msgs) == int(pst.msgs)
    with pytest.raises(TypeError, match="BroadcastProv"):
        PB.flood_step(pst, nbrs=ps.nbrs, nbr_mask=ps.nbr_mask,
                      parts=ps.parts, sync_every=4, prov=object())


@pytest.mark.parametrize("case", ("gather", "wm", "wm_nemesis"))
def test_broadcast_telemetry_only_matches_reference(case):
    # telemetry rides the words-major one-hop paths too (the nemesis's
    # round included); provenance stays off there
    n, nv = 40, 64
    nbrs = to_padded_neighbors(tree(n, branching=4))
    kw = dict(n_values=nv, sync_every=4, srv_ledger=False)
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if case.startswith("wm"):
        jkw["exchange"] = JS.make_exchange("tree", n)
        pkw["exchange"] = PS.make_exchange("tree", n)
    if case == "wm_nemesis":
        spec = full_kw(n)
        jkw.update(fault_plan=JN(**spec).compile(),
                   nemesis=JS.make_nemesis("tree", n, JN(**spec)))
        pkw.update(fault_plan=PN(**spec).compile(device="cpu"),
                   nemesis=PS.make_nemesis("tree", n, PN(**spec),
                                           device="cpu"))
    js, ps = JB.BroadcastSim(nbrs, **jkw), PB.BroadcastSim(nbrs, **pkw)
    inj = JB.make_inject(n, nv)
    jt = JTM.TelemetrySpec("broadcast", 12, series=("msgs", "known_bits",
                                                    "live_nodes"))
    pt = PTM.TelemetrySpec("broadcast", 12, series=("msgs", "known_bits",
                                                    "live_nodes"))
    jst, jtel = js.run_observed(js.stage(inj)[0], js.telemetry_state(jt),
                                jt, 16)
    pst, ptel = ps.run_observed(ps.init_state(inj), ps.telemetry_state(pt),
                                pt, 16)
    assert same(jtel.ring, ptel.ring) and int(jtel.wrote) == ptel.wrote
    np.testing.assert_array_equal(ps.received_node_major(pst),
                                  np.asarray(js.received_node_major(jst)))
    plain = ps.run_staged_fixed(ps.init_state(inj), 16)
    assert torch.equal(plain.received, pst.received)
    assert torch.equal(plain.msgs, pst.msgs)


@pytest.mark.parametrize("mode", ("cas", "allreduce"))
def test_counter_run_observed_matches_reference_every_round(mode):
    n, rounds = 16, 16
    spec = full_kw(n)
    js = JC(n, mode=mode, poll_every=2, fault_plan=JN(**spec).compile(),
            union_block=4 if mode == "allreduce" else None)
    ps = PC(n, mode=mode, poll_every=2, union_block=4 if mode ==
            "allreduce" else None,
            fault_plan=PN(**spec).compile(device="cpu"), device="cpu")
    deltas = np.arange(1, n + 1, dtype=np.int32)
    jsp, psp = JPV.ProvenanceSpec("counter"), PPV.ProvenanceSpec("counter")
    jt, pt = JTM.TelemetrySpec("counter", rounds), PTM.TelemetrySpec(
        "counter", rounds)
    jst, pst = js.add(js.init_state(), deltas), ps.add(ps.init_state(),
                                                       deltas)
    jtel, ptel = js.telemetry_state(jt), ps.telemetry_state(pt)
    jpr, ppr = js.provenance_state(jsp), ps.provenance_state(psp)
    for _ in range(rounds):
        jst, jtel, jpr = js.run_observed(jst, jtel, jt, 1, prov=jpr,
                                         prov_spec=jsp)
        pst, ptel, ppr = ps.run_observed(pst, ptel, pt, 1, prov=ppr,
                                         prov_spec=psp)
        for f in ("pending", "cached", "kv", "msgs"):
            assert same(getattr(jst, f), getattr(pst, f)), f
        assert same(jtel.ring, ptel.ring) and same_prov(jpr, ppr)
    # the donated trip equals the plain run and records the same stamps
    obs, ppr2 = ps.run_observed(ps.add(ps.init_state(), deltas), None, None,
                                rounds, donate=True,
                                prov=ps.provenance_state(psp),
                                prov_spec=psp)
    plain = ps.run(ps.add(ps.init_state(), deltas), rounds)
    for f in ("pending", "cached", "kv", "msgs"):
        assert torch.equal(getattr(obs, f), getattr(plain, f)), f
    assert all(torch.equal(a, b) for a, b in zip(ppr2, ppr))
    ok, det = check_provenance("counter", PPV.arrays_of(ppr2),
                               spec=PN(**spec), final_kv=int(obs.kv))
    assert ok, det["problems"]
    assert det["n_flushed"] > 0


@pytest.mark.parametrize("repl", ("union", "union_nem", "union_nem_slabs"))
def test_kafka_run_observed_matches_reference_every_round(repl):
    n, k, rounds = 16, 4, 12
    spec = full_kw(n)
    sks, svs, crs = JNM.stage_kafka_ops(JN(**spec), rounds, n_keys=k,
                                        max_sends=2, workload_seed=0)
    kw = dict(capacity=64, max_sends=2, resync_every=4,
              union_block=4 if repl == "union_nem_slabs" else None)
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if repl != "union":
        jkw["fault_plan"] = JN(**spec).compile()
        pkw["fault_plan"] = PN(**spec).compile(device="cpu")
    js, ps = JK(n, k, **jkw), PK(n, k, **pkw)
    jsp = JPV.ProvenanceSpec("kafka", witness=3)
    psp = PPV.ProvenanceSpec("kafka", witness=3)
    full = ("live_nodes", "alloc_total", "present_bits",
            "present_bits_full", "msgs")
    jt = JTM.TelemetrySpec("kafka", rounds, series=full)
    pt = PTM.TelemetrySpec("kafka", rounds, series=full)
    jst, pst = js.init_state(), ps.init_state()
    jtel, ptel = js.telemetry_state(jt), ps.telemetry_state(pt)
    jpr, ppr = js.provenance_state(jsp), ps.provenance_state(psp)
    for r in range(rounds):
        one = slice(r, r + 1)
        jst, jtel, jpr = js.run_observed(jst, jtel, jt, sks[one], svs[one],
                                         crs[one], prov=jpr, prov_spec=jsp)
        pst, ptel, ppr = ps.run_observed(pst, ptel, pt, sks[one], svs[one],
                                         crs[one], prov=ppr, prov_spec=psp)
        for f in ("log_vals", "present", "kv_val", "local_committed",
                  "msgs"):
            assert same(getattr(jst, f), getattr(pst, f)), f
        assert same(jtel.ring, ptel.ring) and same_prov(jpr, ppr)
    obs, ppr2 = ps.run_observed(ps.init_state(), None, None, sks, svs, crs,
                                donate=True, prov=ps.provenance_state(psp),
                                prov_spec=psp)
    plain = ps.run_rounds(ps.init_state(), sks, svs, crs)
    for f in ("log_vals", "present", "kv_val", "local_committed", "msgs"):
        assert torch.equal(getattr(obs, f), getattr(plain, f)), f
    assert all(torch.equal(a, b) for a, b in zip(ppr2, ppr))
    if repl != "union":
        ok, det = check_provenance(
            "kafka", PPV.arrays_of(ppr2), spec=PN(**spec), n_nodes=n,
            resync_every=4, resync_mode="pull", witness=3)
        assert ok, det["problems"]
    allocated = obs.log_vals >= 0
    assert torch.equal(ppr2.alloc_round >= 1, allocated)
    assert torch.equal(ppr2.origin >= 0, allocated)


# -- falsifiability: the reference's forged records ----------------------


def _certified_broadcast():
    n, nv = 16, 32
    spec = PN(n_nodes=n, seed=3, crash=((2, 5, (1,)),), loss_rate=0.2,
              loss_until=8)
    nbrs = to_padded_neighbors(tree(n, branching=4))
    sim = PB.BroadcastSim(nbrs, n_values=nv, sync_every=4, srv_ledger=False,
                          fault_plan=spec.compile(device="cpu"),
                          device="cpu")
    inj = PB.make_inject(n, nv)
    psp = PPV.ProvenanceSpec("broadcast")
    s, prov = sim.run_observed(sim.init_state(inj), None, None, 16,
                               donate=True,
                               prov=sim.provenance_state(psp, inj),
                               prov_spec=psp)
    arrs = PPV.arrays_of(prov)
    ctx = dict(spec=spec, nbrs=nbrs, received=host_unpack_bits(
        sim.received_node_major(s), nv), msgs_total=int(s.msgs))
    ok, det = check_provenance("broadcast", arrs, **ctx)
    assert ok, det["problems"]
    return arrs, ctx


def test_forged_parent_on_dead_edge_fails():
    spec = PN(n_nodes=3, seed=1, crash=((2, 20, (1,)),))
    nbrs = np.array([[1, -1], [0, 2], [1, -1]], np.int32)
    arrs = {"arrival": np.array([[0], [2], [5]], np.int32),
            "parent": np.array([[-1], [0], [1]], np.int32)}
    kw = dict(spec=spec, nbrs=nbrs, received=np.ones((3, 1), bool),
              msgs_total=100)
    ok, det = check_provenance("broadcast", arrs, **kw)
    assert not ok
    assert any("dead or dropped" in p for p in det["problems"])
    arrs["arrival"][2, 0] = 3          # delivered by send round 2: down
    assert not check_provenance("broadcast", arrs, **kw)[0]
    arrs2 = {"arrival": np.array([[0], [1], [2]], np.int32),
             "parent": np.array([[-1], [0], [1]], np.int32)}
    ok3, det3 = check_provenance("broadcast", arrs2, **kw)
    assert ok3, det3["problems"]


def test_forged_parent_on_dropped_edge_fails():
    spec = PN(n_nodes=2, seed=1, loss_rate=1.0, loss_until=100)
    arrs = {"arrival": np.array([[0], [3]], np.int32),
            "parent": np.array([[-1], [0]], np.int32)}
    ok, det = check_provenance(
        "broadcast", arrs, spec=spec, nbrs=np.array([[1], [0]], np.int32),
        received=np.array([[True], [True]]), msgs_total=100)
    assert not ok
    assert any("dropped" in p for p in det["problems"])


def test_causality_violating_arrival_fails():
    arrs, ctx = _certified_broadcast()
    ii, vv = np.nonzero((arrs["arrival"] > 0) & (arrs["parent"] >= 0))
    i, v = ii[0], vv[0]
    p = arrs["parent"][i, v]
    arrs["arrival"][p, v] = arrs["arrival"][i, v] + 1
    ok, det = check_provenance("broadcast", arrs, **ctx)
    assert not ok
    assert any("causality" in p_ for p_ in det["problems"])


def test_tree_inconsistent_msgs_ledger_fails():
    arrs, ctx = _certified_broadcast()
    ctx["msgs_total"] = 3
    ok, det = check_provenance("broadcast", arrs, **ctx)
    assert not ok
    assert any("msgs" in p and "ledger" in p for p in det["problems"])
    arrs2, ctx2 = _certified_broadcast()
    i = int(np.argmax(arrs2["arrival"].max(axis=1)))
    v = int(np.argmax(arrs2["arrival"][i]))
    arrs2["arrival"][i, v] = -1
    arrs2["parent"][i, v] = -1
    ok2, det2 = check_provenance("broadcast", arrs2, **ctx2)
    assert not ok2
    assert any("no recorded arrival" in p for p in det2["problems"])


def test_counter_forged_flush_fails():
    n = 16
    spec = PN(n_nodes=n, seed=3, crash=((2, 6, (1,)),))
    arrs = {f: np.full(n, -1, np.int32)
            for f in ("flush_round", "flush_kv", "visible_round")}
    arrs["flush_round"][1] = 4
    arrs["flush_kv"][1] = 2
    ok, det = check_provenance("counter", arrs, spec=spec, final_kv=10)
    assert not ok and any("forged flush" in p for p in det["problems"])
    arrs["flush_round"][1] = 10
    arrs["flush_kv"][1] = 99
    ok, det = check_provenance("counter", arrs, spec=spec, final_kv=10)
    assert not ok and any("monotone" in p for p in det["problems"])


def test_kafka_forged_stamps_fail():
    n, k, cap = 8, 2, 8
    spec = PN(n_nodes=n, seed=3, crash=((2, 6, (1,)),))
    base = {f: np.full((k, cap), -1, np.int32)
            for f in ("alloc_round", "origin", "first_present")}

    def forged(**cells):
        arrs = {f: a.copy() for f, a in base.items()}
        for f, (kk, cc, val) in cells.items():
            arrs[f][kk, cc] = val
        return check_provenance("kafka", arrs, spec=spec, n_nodes=n,
                                resync_every=4, resync_mode="pull",
                                witness=0)

    ok, det = forged(alloc_round=(0, 0, 4), origin=(0, 0, 1),
                     first_present=(0, 0, 4))
    assert not ok and any("forged allocation" in p for p in det["problems"])
    ok, det = forged(alloc_round=(0, 0, 7), origin=(0, 0, 2),
                     first_present=(0, 0, 3))
    assert not ok and any("BEFORE its allocation" in p
                          for p in det["problems"])
    ok, det = forged(alloc_round=(0, 0, 7), origin=(0, 0, 2),
                     first_present=(0, 0, 10))
    assert not ok and any("not a resync round" in p
                          for p in det["problems"])


# -- dissemination trees, divergence, knobs, the record's carry ----------


def _tree_spec():
    return dict(n_nodes=16, seed=5, crash=((2, 5, (1, 8)),),
                loss_rate=0.15, loss_until=8)


def test_dissemination_tree_summary():
    res = PNM.run_broadcast_nemesis(PN(**_tree_spec()), provenance=True,
                                    device="cpu")
    assert res["ok"]
    d = res["provenance"]["tree"]
    POB.validate_tree(d)
    assert d["n_tree_edges"] == res["provenance"]["check"]["n_tree_edges"]
    for row in d["values"]:
        assert row["span_rounds"] >= row["depth_hops"] >= 0
        assert row["n_reached"] >= 1
    cp = d["critical_path"]
    assert cp["span_rounds"] == d["max_span_rounds"]
    assert cp["chain"][0]["round"] == 0
    assert cp["chain"][-1]["round"] == cp["span_rounds"]
    assert d["edges"] and all(e["n_values"] >= 1 for e in d["edges"])
    want = JNM.run_broadcast_nemesis(JN(**_tree_spec()), provenance=True)
    assert d == want["provenance"]["tree"]
    with pytest.raises(ValueError, match="schema"):
        POB.validate_tree(dict(d, schema="x"))


@pytest.mark.parametrize("seed", range(6))
def test_dissemination_tree_matches_reference_on_seeded_records(seed):
    rng = np.random.default_rng(seed)
    n, nv = int(rng.integers(1, 40)), int(rng.integers(1, 12))
    arrival = np.where(rng.random((n, nv)) < 0.7,
                       rng.integers(0, 9, (n, nv)), -1).astype(np.int32)
    parent = np.where(arrival > 0, rng.integers(-1, n, (n, nv)),
                      -1).astype(np.int32)
    arrs = {"arrival": arrival, "parent": parent}
    for kw in ({}, {"max_edges": 3, "max_chain": 2}):
        assert POB.dissemination_tree(arrs, **kw) \
            == JOB.dissemination_tree(arrs, **kw)


def test_divergence_rounds_and_checker_hooks():
    exp = {"_round": [0, 1, 2], "msgs": [4, 8, 12], "live_nodes": [8, 8, 8]}
    assert series_divergence_round(exp, exp) is None
    got = {"_round": [0, 1, 2], "msgs": [4, 8, 13], "live_nodes": [8, 8, 8]}
    assert series_divergence_round(exp, got) == 2
    ok, det = check_telemetry(got, expected=exp)
    assert not ok and det["first_divergence_round"] == 2
    a = {"arrival": np.array([[0, 3], [2, -1]], np.int32)}
    b = {"arrival": np.array([[0, 3], [2, -1]], np.int32)}
    assert provenance_divergence_round(a, b) is None
    b["arrival"][1, 0] = 5
    assert provenance_divergence_round(a, b) == 2
    assert provenance_divergence_round(
        a, {"arrival": np.zeros((3, 3), np.int32)}) == 0
    _, det = check_recovery(clear_round=4, converged_round=6,
                            max_recovery_rounds=8, lost_writes=[],
                            divergence=3)
    assert det["first_divergence_round"] == 3


def test_env_switch_drives_runners(monkeypatch):
    spec = PN(n_nodes=8, seed=3, crash=((12, 16, (1,)),))
    monkeypatch.setenv("GG_PROVENANCE", "1")
    res = PNM.run_counter_nemesis(spec, device="cpu")
    assert res["ok"] and "provenance" in res
    assert res["provenance"]["check"]["n_flushed"] > 0
    monkeypatch.delenv("GG_PROVENANCE")
    res_off = PNM.run_counter_nemesis(spec, device="cpu")
    assert "provenance" not in res_off
    assert res_off["converged_round"] == res["converged_round"]
    assert res_off["msgs_total"] == res["msgs_total"]


def test_env_knob_is_loud(monkeypatch):
    for bad in ("yes", "2"):
        monkeypatch.setenv("GG_PROVENANCE", bad)
        with pytest.raises(ValueError, match="GG_PROVENANCE"):
            PPV.enabled()
    monkeypatch.setenv("GG_PROVENANCE", "1")
    assert PPV.enabled() is True
    assert POB.provenance_setup(None, "kafka") == PPV.ProvenanceSpec("kafka")
    monkeypatch.delenv("GG_PROVENANCE")
    assert PPV.enabled() is False
    assert POB.provenance_setup(None, "kafka") is None
    assert POB.provenance_setup(False, "kafka") is None
    with pytest.raises(ValueError, match="does not match"):
        POB.provenance_setup(PPV.ProvenanceSpec("counter"), "kafka")


def test_observed_driver_refusals():
    nbrs = to_padded_neighbors(tree(8, branching=4))
    psp = PPV.ProvenanceSpec("broadcast")
    inj = np.zeros((8, 1), np.uint32)
    wm = PB.BroadcastSim(nbrs, n_values=16, device="cpu",
                         exchange=PS.make_exchange("tree", 8, branching=4))
    with pytest.raises(ValueError, match="words-major|gather"):
        wm.run_observed(wm.init_state(inj), None, None, 2,
                        prov=wm.provenance_state(psp, inj), prov_spec=psp)
    delayed = PB.BroadcastSim(
        nbrs, n_values=16, device="cpu",
        exchange=PS.make_exchange("tree", 8),
        delayed=PS.make_delayed("tree", 8, (1, 2)))
    tsp = PTM.TelemetrySpec("broadcast", 4)
    with pytest.raises(ValueError, match="delay-ring"):
        delayed.run_observed(delayed.init_state(inj),
                             delayed.telemetry_state(tsp), tsp, 1)
    gather = PB.BroadcastSim(nbrs, n_values=16, device="cpu")
    for kw, match in ((dict(tel=None, tspec=tsp), "together"),
                      (dict(tel=None, tspec=None), "TelemetrySpec"),
                      (dict(tel=gather.telemetry_state(tsp),
                            tspec=PTM.TelemetrySpec("counter", 4)),
                       "workload")):
        with pytest.raises(ValueError, match=match):
            gather.run_observed(gather.init_state(inj), kw["tel"],
                                kw["tspec"], 1)
    with pytest.raises(ValueError, match="together"):
        gather.run_observed(gather.init_state(inj), None, None, 1,
                            prov_spec=psp)
    with pytest.raises(ValueError, match="workload"):
        gather.run_observed(gather.init_state(inj), None, None, 1,
                            prov=object(),
                            prov_spec=PPV.ProvenanceSpec("kafka"))
    ks = PK(4, 2, 8, device="cpu", repl_fast=False)
    ksp = PPV.ProvenanceSpec("kafka")
    sk = np.full((1, 4, 4), -1, np.int32)
    with pytest.raises(ValueError, match="matmul"):
        ks.run_observed(ks.init_state(), None, None, sk, sk,
                        prov=ks.provenance_state(ksp), prov_spec=ksp)
    ks = PK(4, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="witness"):
        ks.run_observed(ks.init_state(), None, None, sk, sk,
                        prov=ks.provenance_state(ksp),
                        prov_spec=PPV.ProvenanceSpec("kafka", witness=4))
    cs = PC(4, device="cpu")
    with pytest.raises(ValueError, match="traffic=False"):
        tt = PTM.TelemetrySpec("counter", 4, traffic=True)
        cs.run_observed(cs.init_state(), cs.telemetry_state(tt), tt, 1)


def test_spec_record_and_carry_across_packages():
    spec = PPV.ProvenanceSpec("kafka", witness=3)
    assert PPV.ProvenanceSpec.from_meta(spec.to_meta()) == spec
    assert spec.to_meta() == JPV.ProvenanceSpec("kafka", witness=3).to_meta()
    with pytest.raises(ValueError, match="workload"):
        PPV.ProvenanceSpec("paxos")
    with pytest.raises(ValueError, match="witness"):
        PPV.ProvenanceSpec("kafka", witness=-1)
    # a reference record crosses into the port and back unchanged
    n, nv = 16, 40
    js = JB.BroadcastSim(to_padded_neighbors(tree(n)), n_values=nv,
                         sync_every=4, srv_ledger=False,
                         fault_plan=JN(**full_kw(n)).compile())
    inj = JB.make_inject(n, nv)
    psp = JPV.ProvenanceSpec("broadcast")
    _, jprov = js.run_observed(js.stage(inj)[0], None, None, 9,
                               prov=js.provenance_state(psp, inj),
                               prov_spec=psp)
    want = JPV.arrays_of(jprov)
    port = PPV.from_arrays("broadcast", want, device="cpu")
    got = PPV.arrays_of(port)
    assert sorted(got) == sorted(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
    back = JPV.from_arrays("broadcast", got)
    assert same_prov(jprov, back)
    assert PPV.depth_of("broadcast", got) == JPV.depth_of("broadcast", want)
    assert int(PPV.critical_depth(port.arrival)) \
        == int(JPV.critical_depth(jprov.arrival))
    # the fresh records and the stamp write equal the reference's
    assert same_prov(JPV.init_counter(5), PPV.init_counter(5, "cpu"))
    assert same_prov(JPV.init_kafka(3, 7), PPV.init_kafka(3, 7, "cpu"))
    assert same_prov(JPV.init_broadcast(n, nv, inj),
                     PPV.init_broadcast(n, nv, inj, "cpu"))
    cur = np.array([-1, 3, -1, 0], np.int32)
    mask = np.array([True, True, False, True])
    assert same(JPV.stamp(jnp.asarray(cur), jnp.asarray(mask), 9),
                PPV.stamp(torch.from_numpy(cur), torch.from_numpy(mask), 9))
    # the shard specs are the reference's, leaf for leaf: the broadcast
    # and counter stamps split by node, Kafka's whole on every rank
    for port_specs, ref_specs in ((PPV.broadcast_specs(),
                                   JPV.broadcast_specs()),
                                  (PPV.counter_specs(),
                                   JPV.counter_specs()),
                                  (PPV.kafka_specs(), JPV.kafka_specs())):
        assert type(port_specs)._fields == type(ref_specs)._fields
        assert [tuple(x) for x in port_specs] == \
            [tuple(x) for x in ref_specs]
    with pytest.raises(NotImplementedError, match="item 14"):
        PPV.audit_contracts()
    # the flight recorder carries the record: a bundle with these stamps
    # loads back, and the timeline draws the reference's flows of them
    bundle = {"schema": POB.BUNDLE_SCHEMA, "kind": "nemesis",
              "provenance": {f: np.asarray(v).tolist()
                             for f, v in got.items()}}
    assert POB.load_bundle(bundle) is bundle
    assert POB.replay_divergence(bundle, {"provenance": {"arrays": want}}) \
        is None
    result = {"workload": "broadcast", "converged_round": 9,
              "provenance": {"spec": psp.to_meta(), "arrays": got}}
    assert POB.run_timeline(result) == JOB.run_timeline(
        dict(result, provenance={"spec": psp.to_meta(), "arrays": want}))


def test_partitions_meta_round_trips_like_reference():
    group = np.random.default_rng(2).integers(0, 3, (2, 9)).astype(np.int8)
    jp = JB.Partitions(jnp.asarray([1, 4], jnp.int32),
                       jnp.asarray([3, 8], jnp.int32), jnp.asarray(group))
    pp = PB.Partitions.from_numpy([1, 4], [3, 8], group)
    assert pp.to_meta() == jp.to_meta()
    back = PB.Partitions.from_meta(jp.to_meta())
    assert back.starts == pp.starts and back.ends == pp.ends
    assert torch.equal(back.group, pp.group)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        PB.Partitions.from_meta({"starts": [1], "ends": [2],
                                 "group": [0, 1]})


def test_provenance_on_equals_off_for_the_three_sims():
    # the recorders only read: each observed state equals the plain
    # drivers' bit for bit, with and without the telemetry ring
    spec = full_kw(16)
    cs = PC(16, mode="cas", poll_every=2, device="cpu",
            fault_plan=PN(**spec).compile(device="cpu"))
    d = np.arange(1, 17, dtype=np.int32)
    plain = cs.run(cs.add(cs.init_state(), d), 12)
    obs = cs.run_observed(cs.add(cs.init_state(), d), None, None, 12,
                          prov=cs.provenance_state(None),
                          prov_spec=PPV.ProvenanceSpec("counter"))[0]
    assert all(torch.equal(getattr(plain, f), getattr(obs, f))
               for f in ("pending", "cached", "kv", "msgs"))
    _, ps = _broadcast_pair("plan_dup", n=24, nv=40)
    inj = PB.make_inject(24, 40)
    plain = ps.run_staged_fixed(ps.init_state(inj), 12)
    psp = PPV.ProvenanceSpec("broadcast")
    tsp = PTM.TelemetrySpec("broadcast", 12)
    obs = ps.run_observed(ps.init_state(inj), ps.telemetry_state(tsp), tsp,
                          12, prov=ps.provenance_state(psp, inj),
                          prov_spec=psp)[0]
    assert torch.equal(plain.received, obs.received)
    assert torch.equal(plain.frontier, obs.frontier)
    assert torch.equal(plain.msgs, obs.msgs)
