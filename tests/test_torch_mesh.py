"""The port's 1-D mesh against the JAX package's on its virtual-device
mesh: the collectives, the halo primitives, the halo and masked halo
exchanges and sync diffs, the tree halo kernels' plain twins, the
``make_sharded_exchange`` gates and the refusals (ROADMAP.md Queue A item
10).

The port side runs in spawned worlds of P gloo ranks on the CPU
(``dcn_worker.spawn_world``: P = 4, and P = 2 for fewer shards than the
tree's branching), one world a P for the whole file, each rank running
``torch_mesh_cases``; the JAX side runs the reference's ``shard_map``
bodies on ``pick_mesh(max_axis=P)``.  Every comparison is exact
(tolerance 0: bitsets, ids and integer sums)."""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import jax
import jax.numpy as jnp
import torch_mesh_cases as C
from gossip_glomers_tpu.parallel.mesh import pick_mesh as jpick_mesh
from gossip_glomers_tpu.tpu_sim import engine as je
from gossip_glomers_tpu.tpu_sim import structured as jst
from gossip_glomers_tpu_torch.parallel import dcn_worker, mesh as pmesh
from gossip_glomers_tpu_torch.tpu_sim import engine, kernels, structured

SEED = 19
# a world failing or hanging fails its tests within this many seconds
WORLD_TIMEOUT = 60.0


@pytest.fixture(scope="module")
def world4():
    return dcn_worker.spawn_world(C.mesh_cases, 4, backend="gloo",
                                  device="cpu", args=(SEED,),
                                  timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world2():
    return dcn_worker.spawn_world(C.mesh_cases_p2, 2, backend="gloo",
                                  device="cpu", args=(SEED,),
                                  timeout=WORLD_TIMEOUT)


def stitch(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def jrun(mesh, fn, in_specs, out_specs, *args):
    prog = je.jit_program(fn, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
    out = prog(*args)
    return jax.tree_util.tree_map(np.asarray, out)


# -- the collectives ---------------------------------------------------------


def _coll_inputs(k):
    n = k * C.COLL_ROWS
    x = C.words((n, 3), SEED)
    y = np.random.default_rng(SEED + 1).integers(
        -1 << 40, 1 << 40, (n, 2)).astype(np.int64)
    m = np.random.default_rng(SEED + 2).integers(0, 100, (n, n))
    return x, y, m


def test_mesh_collectives_match_reference(world4):
    ranks = [r["collectives"] for r in world4]
    k = len(ranks)
    x, y, m = _coll_inputs(k)
    y32 = (y >> 30).astype(np.int32)
    mesh = jpick_mesh(max_axis=k)

    def f(xs, ys, mm):
        coll = je.collectives(C.COLL_ROWS, mesh)
        return (coll.row_ids, coll.reduce_or(xs), coll.reduce_and(xs),
                coll.exclusive_sum(ys), coll.reduce_sum(ys),
                coll.reduce_max(ys), coll.reduce_min(ys),
                coll.widen(xs)[None], coll.local_cols(mm))

    got = jrun(mesh, f, (P("nodes"), P("nodes"), P()),
               (P("nodes"),) * 8 + (P(None, "nodes"),),
               jnp.asarray(x), jnp.asarray(y32), jnp.asarray(m))
    want = dict(zip(("row_ids", "reduce_or", "reduce_and",
                     "exclusive_sum32", "reduce_sum32", "reduce_max32",
                     "reduce_min32", "widen"), got[:8]))
    for key, val in want.items():
        mine = (np.stack([r[key] for r in ranks]) if key == "widen"
                else stitch(ranks, key, 0))
        # the ranks' int32 words come back as their uint32 view
        np.testing.assert_array_equal(mine.view(val.dtype), val,
                                      err_msg=key)
    np.testing.assert_array_equal(stitch(ranks, "local_cols", 1), got[8])
    # the int64 operands (the ledgers' dtype) against numpy
    blocks = y.reshape(k, C.COLL_ROWS, 2)
    excl = np.concatenate([np.zeros_like(blocks[:1]),
                           np.cumsum(blocks, axis=0)[:-1]])
    np.testing.assert_array_equal(stitch(ranks, "exclusive_sum", 0),
                                  excl.reshape(-1, 2))
    for key, fn in (("reduce_sum", np.sum), ("reduce_max", np.max),
                    ("reduce_min", np.min)):
        for r in ranks:
            np.testing.assert_array_equal(r[key], fn(blocks, axis=0))
    # the OR / AND / prefix circuits are ppermutes only: no all-gather
    # and no all-reduce (NCCL has no bitwise all-reduce)
    for r in ranks:
        assert r["ladder_calls"]["all_gather"] == 0
        assert r["ladder_calls"]["all_reduce"] == 0
        assert r["ladder_calls"]["ppermute"] > 0
        assert r["axis_name"] == "nodes"


# -- the halo primitives -----------------------------------------------------


def test_sharded_roll_and_shift_match_reference(world4):
    ranks = [r["halo"] for r in world4]
    k, block, w = len(ranks), 8, 3
    n = k * block
    x = C.words((w, n), SEED)
    mesh = jpick_mesh(max_axis=k)
    spec = P(None, "nodes")
    for kind, specs in (("roll", C.ROLL_SHIFTS), ("shift", C.SHIFT_SHIFTS)):
        for s_spec in specs:
            s = C.shift_value(s_spec, block)
            if kind == "roll":
                fn = lambda xs, s=s: je.sharded_roll(  # noqa: E731
                    xs, s, n, k, "nodes")
                plain = np.roll(x, s, axis=1)
            else:
                fn = lambda xs, s=s: je.sharded_shift(  # noqa: E731
                    xs, s, k, "nodes")
                idx = np.arange(n) + s
                plain = np.where((idx >= 0) & (idx < n),
                                 x[:, np.clip(idx, 0, n - 1)], 0)
            want = jrun(mesh, fn, (spec,), spec, jnp.asarray(x))
            mine = stitch(ranks, (kind, s_spec), 1)
            np.testing.assert_array_equal(mine, want, err_msg=str(s_spec))
            np.testing.assert_array_equal(mine, plain, err_msg=str(s_spec))


# -- the halo exchanges and sync diffs ---------------------------------------


def _jexchange_case(k, seed, i, topo, n, kw, w):
    mesh = jpick_mesh(max_axis=k)
    p = C.words((w, n), seed + i)
    spec = P(None, "nodes")
    ex = jst.make_sharded_exchange(topo, n, k, **kw)
    df = jst.make_sharded_sync_diff(topo, n, k, **kw)
    f = jst.make_faulted(topo, n, C.halo_groups(n, seed + i), n_shards=k,
                         **kw)
    live = C.live_rows(f.exists.shape[0], n, seed + 100 + i)

    def body(ps, lv):
        return (ex(ps), df(ps)[None], f.sharded_exchange(ps, lv),
                f.sharded_sync_diff(ps, lv)[None])

    got = jrun(mesh, body, (spec, spec),
               (spec, P("nodes"), spec, P("nodes")),
               jnp.asarray(p), jnp.asarray(live))
    full = np.asarray(jst.make_exchange(topo, n, **kw)(jnp.asarray(p)))
    return got, full


def _check_exchanges(ranks, cases, w):
    k = len(ranks)
    for i, (topo, n, kw) in enumerate(cases):
        rs = [r["exchanges"][(topo, n)] for r in ranks]
        (ex, df, mex, mdf), full = _jexchange_case(k, SEED, i, topo, n, kw,
                                                   w)
        mine = np.concatenate([r["exchange"] for r in rs], axis=1)
        np.testing.assert_array_equal(mine, ex, err_msg=f"{topo} {n}")
        np.testing.assert_array_equal(mine, full, err_msg=f"{topo} {n}")
        np.testing.assert_array_equal([r["sync_diff"] for r in rs], df)
        np.testing.assert_array_equal(
            np.concatenate([r["masked"] for r in rs], axis=1), mex,
            err_msg=f"masked {topo} {n}")
        np.testing.assert_array_equal([r["masked_sync_diff"] for r in rs],
                                      mdf)
        for r in rs:      # the halo path makes no all-gather
            assert r["calls"]["all_gather"] == 0, (topo, n)
            assert r["calls"]["all_reduce"] == 0, (topo, n)


def test_halo_exchanges_and_sync_diffs_match_reference(world4):
    _check_exchanges(world4, C.HALO_CASES, 2)


def test_tree_halo_with_fewer_shards_than_branching(world2):
    # P = 2 < k: only some of the k multicast pairs exist each round
    _check_exchanges(world2, C.P2_TREES, 3)


@pytest.mark.parametrize("p_ranks", (2, 4))
def test_tree_halo_halves_match_reference(world2, world4, p_ranks):
    ranks = world4 if p_ranks == 4 else world2
    parts = [r["tree_parts"] for r in ranks]
    n, k, w = 64, 4, (3 if p_ranks == 4 else 1)
    p = C.words((w, n), SEED)
    mesh = jpick_mesh(max_axis=p_ranks)
    spec = P(None, "nodes")

    def body(ps):
        return (jst.tree_parent_payload(ps, n, p_ranks, k),
                jst.tree_kids_payload(ps, n, p_ranks, k),
                jst.tree_sharded_exchange(ps, n, p_ranks, k))

    got = jrun(mesh, body, (spec,), (spec,) * 3, jnp.asarray(p))
    for key, want in zip(("parent", "kids", "exchange"), got):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in parts], axis=1), want,
            err_msg=key)


def test_p2_world_halo_sim_matches_one_process(world2):
    from gossip_glomers_tpu_torch.tpu_sim import broadcast

    n = 64
    sim = broadcast.BroadcastSim(
        C._topo("tree", n, {}), n_values=64, sync_every=5, device="cpu",
        exchange=structured.make_exchange("tree", n),
        sync_diff=structured.make_sync_diff("tree", n))
    state, rounds = sim.run(broadcast.make_inject(n, 64))
    for r in world2:
        got = r["sim"]
        assert got["rounds"] == rounds
        np.testing.assert_array_equal(got["received"],
                                      sim.received_node_major(state))
        assert (got["msgs"], got["srv"]) == (int(state.msgs),
                                             int(state.srv_msgs))


# -- the gates (no world needed) ---------------------------------------------


GATE_CASES = [("tree", 24, 8, {}), ("grid", 64, 8, {}), ("tree", 30, 8, {}),
              ("full", 64, 8, {}), ("tree", 64, 8, {}), ("grid", 256, 8, {}),
              ("line", 64, 8, {}), ("line", 8, 8, {}), ("line", 16, 8, {}),
              ("ring", 12, 8, {}), ("ring", 16, 4, {}),
              ("circulant", 64, 4, {"strides": [1, 5]}),
              ("tree", 16, 4, {}), ("tree", 12, 4, {}),
              ("tree", 32, 2, {"branching": 8}),
              ("tree", 24, 4, {"branching": 2}),
              ("grid", 256, 16, {}), ("grid", 100, 4, {"cols": 10}),
              ("grid", 100, 4, {"cols": 25}), ("random", 64, 4, {})]


@pytest.mark.parametrize("topo,n,shards,kw", GATE_CASES,
                         ids=[f"{t}-{n}-{s}" for t, n, s, _ in GATE_CASES])
def test_make_sharded_exchange_gates_match_reference(topo, n, shards, kw):
    want = jst.make_sharded_exchange(topo, n, shards, **kw) is None
    assert (structured.make_sharded_exchange(topo, n, shards, **kw)
            is None) == want
    assert (structured.make_sharded_sync_diff(topo, n, shards, **kw)
            is None) == (jst.make_sharded_sync_diff(topo, n, shards, **kw)
                         is None)
    assert structured.has_sharded_exchange(topo, n, shards, **kw) == \
        jst.has_sharded_exchange(topo, n, shards, **kw)


def test_reference_gate_asserts():
    # test_make_sharded_exchange_shape_gates's own cases
    mse = structured.make_sharded_exchange
    assert mse("tree", 24, 8) is None
    assert mse("grid", 64, 8) is None
    assert mse("tree", 30, 8) is None
    assert mse("full", 64, 8) is None
    assert mse("tree", 64, 8) is not None
    assert mse("grid", 256, 8) is not None
    assert mse("line", 64, 8) is not None
    # a halo closure runs on a mesh: unbound, it raises
    with pytest.raises(ValueError, match="bind"):
        mse("tree", 64, 8)(torch.zeros((1, 8), dtype=torch.int32))


# -- the tree halo kernels' plain twins --------------------------------------


def _one_shard_mesh():
    return JMesh(np.array(jax.devices()[:1]), ("nodes",))


@pytest.mark.parametrize("w", (1, 3))
@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("with_live", (False, True))
def test_tree_halo_twins_match_reference_composition(w, k, with_live):
    # one shard of B nodes: the reference's sharded tree exchange (and
    # its masked form) is then exactly the twins' composition — the
    # parent buffer [0, p[:, :B/k]] and the kids landing buffer [p[:, 0],
    # the k:1 partial ORs]
    b = 16 * k
    sub = b // k
    p = C.words((w, b), 7 * k + w)
    live = C.live_rows(1, b, 11 * k + w)[0]
    lv = kernels.pack_bits(torch.from_numpy(live)) if with_live else None
    pt = torch.from_numpy(p.view(np.int32))
    partial = kernels.tree_halo_pack_plain(pt, k, lv)
    assert partial.shape == (w, sub + 1)
    masked = np.where(live[None, :], p, 0) if with_live else p
    groups = np.bitwise_or.reduce(
        np.concatenate([masked[:, 1:], np.zeros((w, 1), np.uint32)],
                       axis=1).reshape(w, sub, k), axis=2)
    np.testing.assert_array_equal(
        partial.numpy().view(np.uint32),
        np.concatenate([masked[:, :1], groups], axis=1))
    buf = torch.cat([torch.zeros((w, 1), dtype=torch.int32), pt[:, :sub]],
                    dim=1)
    ek = torch.zeros((w, b + 1), dtype=torch.int32)
    ek[:, :sub + 1] = partial
    inbox = kernels.tree_halo_round_plain(buf, ek, None, k, lv)
    mesh = _one_shard_mesh()
    spec = P(None, "nodes")
    if with_live:
        want = jrun(mesh, lambda ps, lm: jst.tree_masked_sharded_exchange(
            ps, lm, b, 1, k), (spec, spec), spec, jnp.asarray(p),
            jnp.asarray(live[None, :]))
    else:
        want = jrun(mesh, lambda ps: jst.tree_sharded_exchange(
            ps, b, 1, k), (spec,), spec, jnp.asarray(p))
    np.testing.assert_array_equal(inbox.numpy().view(np.uint32), want)
    # the fused form: new = inbox & ~received, received |= new
    rec = torch.from_numpy(C.words((w, b), 5).view(np.int32))
    rec0, nxt = rec.clone(), torch.empty_like(rec)
    kernels.tree_halo_round_plain(buf, ek, None, k, lv, received=rec,
                                  frontier_next=nxt)
    assert torch.equal(nxt, inbox & ~rec0)
    assert torch.equal(rec, rec0 | inbox)


@pytest.mark.parametrize("w", (1, 3))
@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("with_live", (False, True))
def test_tree_halo_round_twin_matches_reference_formula(w, k, with_live):
    # random landing buffers: inbox[:, c] = buf[:, ceil(c/k)] | ek[:, c+1],
    # the parent term expanded as the reference's tree_parent_payload
    # expands it (structured.py:249-252), the back column at c = B - 1
    b = 8 * k
    sub = b // k
    buf, ek, back = (C.words((w, sub + 1), 1), C.words((w, b + 1), 2),
                     C.words((w,), 3))
    live = C.live_rows(1, b, 4)[0]
    parent = np.asarray(jnp.concatenate(
        [jnp.asarray(buf)[:, :1], jnp.repeat(jnp.asarray(buf)[:, 1:], k,
                                              axis=1)], axis=1)[:, :b])
    if with_live:
        parent = np.where(live[None, :], parent, 0)
    want = parent | ek[:, 1:]
    want[:, -1] |= back
    t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    got = kernels.tree_halo_round(
        t(buf), t(ek), t(back), k,
        kernels.pack_bits(torch.from_numpy(live)) if with_live else None)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_tree_halo_wrappers_check_shapes():
    x = torch.zeros((2, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="k | B"):
        kernels.tree_halo_pack(x, 5)
    with pytest.raises(ValueError, match="buf"):
        kernels.tree_halo_round(torch.zeros((2, 3), dtype=torch.int32),
                                torch.zeros((2, 13), dtype=torch.int32),
                                None, 4)
    with pytest.raises(ValueError, match="together"):
        kernels.tree_halo_round(torch.zeros((2, 4), dtype=torch.int32),
                                torch.zeros((2, 13), dtype=torch.int32),
                                None, 4, received=x)
    assert kernels.LAUNCHES["tree_halo_pack"] == 0   # CPU calls count not


# -- refusals ----------------------------------------------------------------


def test_unported_mesh_combinations_raise_item_10(world4):
    # every mesh combination runs now: the traffic and observed drivers
    # (telemetry and provenance), txn, the scenario batches, and since
    # the two-axis slice dcn_mode in every sim, the engine's collectives
    # in a mode and inject_mid on a mesh
    for r in world4:
        assert set(r["refusals"]) == set(C.MESH_RUNS)
        assert {r["refusals"][k] for k in C.MESH_RUNS} == {"ran"}
    # the reference's 2-D meshes and its words axis are built, and are
    # None outside a process group as the reference's are on one device;
    # a bare stale mode and a non-Mesh refuse as the reference's do, and
    # the worker's hosts task set runs off a mesh
    assert pmesh.pick_mesh_2d() is None
    assert pmesh.pick_mesh(axis_name="words") is None
    for fn, err in ((lambda: pmesh.force_virtual_devices(8), ValueError),
                    (lambda: pmesh.init_distributed(num_processes=2,
                                                    local_devices=4),
                     ValueError),
                    (lambda: engine.collectives(4, mesh=object()),
                     TypeError),
                    (lambda: engine.node_shards(object()), TypeError)):
        with pytest.raises(err):
            fn()
    ident = engine.collectives(4, device="cpu", dcn="sync")
    assert ident.axis_name is None
    assert dcn_worker.TASKS["certify"](None, "cpu")["ok"]
    assert dcn_worker.TASKS["takeover"](None, "cpu")["converged"]


def test_pick_mesh_and_init_are_no_ops_in_a_world_of_one():
    assert pmesh.pick_mesh() is None
    assert pmesh.init_distributed(num_processes=1) is False
    with pytest.raises(ValueError, match="coordinator"):
        pmesh.init_distributed(num_processes=2, backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        pmesh.init_distributed(num_processes=2,
                               coordinator_address="localhost:1")
    assert engine.node_shards(None) == 1
    assert pmesh.shard_put(np.arange(6), None).tolist() == list(range(6))
