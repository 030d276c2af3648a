"""Port parity for the structured nemesis's per-direction delays:
``make_nemesis(dir_delays=)`` and the delayed branch of ``_round_wm_nem``
(one coin evaluation a distinct delay at its send round, one ring slot a
delay, the receiver-down columns at delivery time, dup charged at the
payload's popcount) of gossip_glomers_tpu_torch against the JAX
reference on the CPU, and against the port's gather ring under the same
plan through ``gather_delays_for``.

Specs, groups and bitsets come from seeded numpy and go to both
packages; round counts, bitsets, the ring and the ``msgs`` ledger
compare exactly (tolerance 0).  The JAX sims are built with
``mesh=None``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.parallel import topology as jtop
from gossip_glomers_tpu.tpu_sim import broadcast as jbc
from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.tpu_sim import broadcast as pbc
from gossip_glomers_tpu_torch.tpu_sim import faults as pf
from gossip_glomers_tpu_torch.tpu_sim import structured as pst

# (topology, n, kw, dir_delays over the delivery contract's rows)
CASES = [("tree", 64, {}, (1, 2)),
         ("tree", 85, {"branching": 4}, (3, 1)),
         ("grid", 64, {}, (2, 1, 3, 1)),
         ("circulant", 64, {"strides": [1, 5]}, (1, 2, 2, 1)),
         ("ring", 32, {}, (3, 1)),
         ("line", 32, {}, (1, 2))]
IDS = [f"{t}{n}" for t, n, _, _ in CASES]
# the reference's test_structured_nemesis_with_delays_matches_gather spec
SPEC = dict(seed=3, crash=((4, 9, (1, 6, 30)),), loss_rate=0.15,
            loss_until=12, dup_rate=0.2, dup_until=12)


def _nbrs(topo: str, n: int, kw: dict) -> np.ndarray:
    if topo == "circulant":
        return jtop.circulant(n, kw["strides"])
    if topo == "tree":
        return jtop.to_padded_neighbors(jtop.tree(n, kw.get("branching", 4)))
    build = {"grid": jtop.grid, "ring": jtop.ring, "line": jtop.line}[topo]
    return jtop.to_padded_neighbors(build(n))


def _half_parts(n: int):
    groups = np.zeros((1, n), np.int8)
    groups[0, : n // 2] = 1
    return (jbc.Partitions(jnp.array([2], jnp.int32),
                           jnp.array([9], jnp.int32), jnp.asarray(groups)),
            pbc.Partitions.from_numpy([2], [9], groups), groups)


def _sims(topo, n, kw, dd, spec, nv, parts_on=True):
    """(reference structured sim, port structured sim, port gather sim)
    of one spec, dir_delays and (optionally) the half/half window."""
    nbrs = _nbrs(topo, n, kw)
    jparts, pparts, groups = _half_parts(n)
    if not parts_on:
        jparts = jbc.Partitions(jnp.zeros((0,), jnp.int32),
                                jnp.zeros((0,), jnp.int32),
                                jnp.zeros((0, n), jnp.int8))
        pparts, groups = pbc.Partitions.none(n), None
    jspec, pspec = jf.NemesisSpec(n_nodes=n, **spec), pf.NemesisSpec(
        n_nodes=n, **spec)
    ref = jbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=4, parts=jparts,
        exchange=jst.make_exchange(topo, n, **kw),
        fault_plan=jspec.compile(), srv_ledger=False,
        nemesis=jst.make_nemesis(topo, n, jspec, groups=groups,
                                 dir_delays=dd, **kw))
    sim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=4, parts=pparts,
        exchange=pst.make_exchange(topo, n, **kw),
        fault_plan=pspec.compile("cpu"), srv_ledger=False, device="cpu",
        nemesis=pst.make_nemesis(topo, n, pspec, groups=groups,
                                 dir_delays=dd, device="cpu", **kw))
    gsim = pbc.BroadcastSim(
        nbrs, n_values=nv, sync_every=4, parts=pparts, srv_ledger=False,
        fault_plan=pspec.compile("cpu"), device="cpu",
        delays=pst.gather_delays_for(topo, n, dd, nbrs, **kw))
    return ref, sim, gsim


@pytest.mark.parametrize("topo,n,kw,dd", CASES, ids=IDS)
def test_dir_delays_match_reference_and_gather(topo, n, kw, dd):
    nv = 48
    inject = pbc.make_inject(n, nv)
    ref, sim, gsim = _sims(topo, n, kw, dd, SPEC, nv)
    js, jr = ref.run(inject, max_rounds=400)
    ps, pr = sim.run(inject, max_rounds=400)
    gs, gr = gsim.run(inject, max_rounds=400)
    assert pr == jr == gr
    assert sim.ring == max(dd) and ps.history.shape == (max(dd), 2, n)
    np.testing.assert_array_equal(sim.received_node_major(ps),
                                  ref.received_node_major(js))
    np.testing.assert_array_equal(gsim.received_node_major(gs),
                                  sim.received_node_major(ps))
    assert int(ps.msgs) == int(js.msgs) == int(gs.msgs)
    np.testing.assert_array_equal(ps.history.numpy().view(np.uint32),
                                  np.asarray(js.history))
    assert ps.srv_msgs is None


@pytest.mark.parametrize("topo,n,kw,dd", CASES[:4], ids=IDS[:4])
def test_dir_delays_round_by_round(topo, n, kw, dd):
    # every round's state (the ring included) without partitions, dup on
    nv = 40
    inject = pbc.make_inject(n, nv)
    ref, sim, _ = _sims(topo, n, kw, dd, SPEC, nv, parts_on=False)
    js, ps = ref.init_state(inject), sim.init_state(inject)
    for _ in range(14):
        js, ps = ref.step(js), sim.step(ps)
        assert ps.t == int(js.t) and int(ps.msgs) == int(js.msgs)
        np.testing.assert_array_equal(sim.received_node_major(ps),
                                      ref.received_node_major(js))
        np.testing.assert_array_equal(ps.history.numpy().view(np.uint32),
                                      np.asarray(js.history))


def test_dir_delays_dup_is_ledger_only():
    # the dup stream re-delivers in-flight payloads: same received sets,
    # a larger msgs ledger
    n, nv, kw = 64, 48, {"strides": [1, 5]}
    inject = pbc.make_inject(n, nv)
    no_dup = {k: v for k, v in SPEC.items() if not k.startswith("dup")}
    runs = [_sims("circulant", n, kw, (1, 2, 2, 1), spec, nv)[1].run(
        inject, max_rounds=400) for spec in (no_dup, SPEC)]
    (s1, r1), (s2, r2) = runs
    assert r1 == r2
    assert torch.equal(s1.received, s2.received)
    assert int(s2.msgs) > int(s1.msgs)


def test_dir_delays_errors_and_ledger():
    n = 64
    spec = pf.NemesisSpec(n_nodes=n, seed=0, loss_rate=0.1, loss_until=5)
    with pytest.raises(ValueError, match="takes 2 direction delays"):
        pst.make_nemesis("tree", n, spec, dir_delays=(1, 2, 3),
                         device="cpu")
    with pytest.raises(ValueError, match="rounds >= 1"):
        pst.make_nemesis("tree", n, spec, dir_delays=(0, 2), device="cpu")
    halo = pst.make_nemesis("tree", n, spec, dir_delays=(1, 2), n_shards=4,
                            device="cpu")
    assert (halo.sharded_ring_exchange is not None) \
        == pst.has_sharded_exchange("tree", n, 4)
    nem = pst.make_nemesis("tree", n, spec, dir_delays=(1, 3), device="cpu")
    assert nem.dir_delays == (1, 3) and nem.ring == 3
    nbrs = _nbrs("tree", n, {})
    sim = pbc.BroadcastSim(nbrs, n_values=8, exchange=pst.make_exchange(
        "tree", n), fault_plan=spec.compile("cpu"), nemesis=nem,
        device="cpu")
    # the loss-only ledger goes off under dir_delays, as the reference's
    assert sim.init_state(pbc.make_inject(n, 8)).srv_msgs is None
    with pytest.raises(ValueError, match="subsumes"):
        pbc.BroadcastSim(nbrs, n_values=8, exchange=pst.make_exchange(
            "tree", n), fault_plan=spec.compile("cpu"), nemesis=nem,
            delayed=pst.make_delayed("tree", n, (1, 3)), device="cpu")
