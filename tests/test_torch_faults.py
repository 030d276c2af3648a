"""Port parity for the nemesis faults: ``NemesisSpec`` (validation,
``compile``, meta round trip, host mirrors), ``random_spec``, the compiled
``FaultPlan`` and its device evaluators (liveness, amnesia, membership and
the loss / dup coins) of gossip_glomers_tpu_torch against the JAX
reference on the CPU.

Specs and ids come from seeded numpy and go to both packages; every leaf,
mask and coin compares exactly (tolerance 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_glomers_tpu.tpu_sim import faults as jf
from gossip_glomers_tpu_torch.tpu_sim import faults as pf

N = 48

SPECS = {
    "crash": dict(n_nodes=N, seed=3, crash=((2, 6, (1, 5)), (4, 9, (7,)))),
    "loss": dict(n_nodes=N, seed=11, loss_rate=0.3, loss_until=7),
    "dup": dict(n_nodes=N, seed=12, crash=((1, 4, (0, 47)),),
                dup_rate=0.25),
    "crash_loss_dup": dict(n_nodes=N, seed=2**32 + 5,
                           crash=((3, 8, (2, 9, 40)),), loss_rate=0.1,
                           loss_until=10, dup_rate=0.05, dup_until=12),
    "membership": dict(n_nodes=N, seed=9, crash=((2, 5, (3,)),),
                       join=((3, (10, 11)), (6, (20,))),
                       leave=((5, (30,)), (8, (10,)))),
    "empty": dict(n_nodes=N),
}


def _specs(kw):
    return jf.NemesisSpec(**kw), pf.NemesisSpec(**kw)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_plans_equal(jplan, pplan):
    """Leaf for leaf, values and shapes."""
    for name in jf.FaultPlan._fields:
        want = np.asarray(getattr(jplan, name))
        got = np.asarray(_np(getattr(pplan, name)))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_compile_matches_reference(name):
    js, ps = _specs(SPECS[name])
    assert_plans_equal(js.compile(), ps.compile(device="cpu"))
    assert ps.clear_round == js.clear_round
    assert ps.has_membership == js.has_membership
    assert ps.crash == js.crash and ps.join == js.join \
        and ps.leave == js.leave


@pytest.mark.parametrize("seed", (0, 1, 7, 123))
def test_random_spec_matches_reference(seed):
    kw = dict(seed=seed, horizon=17, n_crash_windows=3, crash_frac=0.2,
              loss_rate=0.1, dup_rate=0.05)
    js, ps = jf.random_spec(N, **kw), pf.random_spec(N, **kw)
    assert ps == pf.NemesisSpec(**{f: getattr(js, f) for f in (
        "n_nodes", "seed", "crash", "loss_rate", "loss_until", "dup_rate",
        "dup_until", "join", "leave")})
    assert_plans_equal(js.compile(), ps.compile(device="cpu"))
    with pytest.raises(ValueError, match="horizon"):
        pf.random_spec(N, seed=seed, horizon=1)


BAD_SPECS = [
    dict(n_nodes=8, crash=((3, 3, (1,)),)),
    dict(n_nodes=8, crash=((-1, 3, (1,)),)),
    dict(n_nodes=8, crash=((1, 3, (8,)),)),
    dict(n_nodes=8, join=((0, (1,)),)),
    dict(n_nodes=8, leave=((2, (9,)),)),
    dict(n_nodes=8, join=((2, (1,)), (3, (1,)))),
    dict(n_nodes=8, join=((4, (1,)),), leave=((4, (1,)),)),
    dict(n_nodes=8, loss_rate=1.5, loss_until=3),
    dict(n_nodes=8, dup_rate=-0.1, dup_until=3),
    dict(n_nodes=8, loss_rate=0.1),
    dict(n_nodes=8, dup_rate=0.1),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_bad_specs_raise_the_reference_messages(kw):
    with pytest.raises(ValueError) as want:
        jf.NemesisSpec(**kw)
    with pytest.raises(ValueError) as got:
        pf.NemesisSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_meta_round_trip(name):
    js, ps = _specs(SPECS[name])
    meta = ps.to_meta()
    assert meta == js.to_meta()
    back, jback = pf.NemesisSpec.from_meta(meta), jf.NemesisSpec.from_meta(
        meta)
    assert back.to_meta() == meta
    assert dataclasses.astuple(back) == dataclasses.astuple(jback)
    assert_plans_equal(js.compile(), back.compile(device="cpu"))


@pytest.mark.parametrize("name", ("crash", "membership", "crash_loss_dup"))
def test_host_spec_mirrors_match_reference(name):
    js, ps = _specs(SPECS[name])
    for t in range(-1, 12):
        np.testing.assert_array_equal(ps.host_up(t), js.host_up(t))
        np.testing.assert_array_equal(ps.host_members(t),
                                      js.host_members(t))


def test_plan_from_numpy_carries_the_reference_plan():
    js, ps = _specs(SPECS["membership"])
    leaves = {k: np.asarray(v) for k, v in js.compile()._asdict().items()}
    plan = pf.plan_from_numpy(**leaves)
    assert_plans_equal(js.compile(), plan)
    with pytest.raises(ValueError, match="window leaves"):
        pf.plan_from_numpy(**{**leaves, "ends": np.zeros(5, np.int32)})
    with pytest.raises(ValueError, match="membership column"):
        pf.plan_from_numpy(**{**leaves,
                              "join_round": np.zeros(3, np.int32)})


def _ids(seed, shape=(64,), hi=N):
    return np.random.default_rng(seed).integers(0, hi, shape)


def test_mix32_matches_reference_and_numpy_twin():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64),
                        np.array([0, 1, (1 << 32) - 1, 1 << 31,
                                  0x7FFFFFFF], np.uint64)]).astype(np.uint32)
    want = np.asarray(jf._mix32(jnp.asarray(x)))
    got = pf._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(pf._mix32_np(x), want)
    # products at the top of the range stay exact
    top = torch.tensor([(1 << 32) - 1], dtype=torch.int64)
    assert int(pf._mul32(top, 0x846CA68B)) \
        == ((1 << 32) - 1) * 0x846CA68B % (1 << 32)


def _times(until):
    return sorted({0, 1, until - 1, until, until + 3} - {-1})


@pytest.mark.parametrize("name", ("loss", "crash_loss_dup", "dup"))
def test_coins_match_reference(name):
    js, ps = _specs(SPECS[name])
    jplan, pplan = js.compile(), ps.compile(device="cpu")
    src, dst = _ids(1, (8, 16)), _ids(2, (16,))
    for t in _times(max(pplan.loss_until, pplan.dup_until, 2)):
        tj = jnp.int32(t)
        for salt in (jf._SALT_LOSS, jf._SALT_DUP):
            np.testing.assert_array_equal(
                pf._edge_hash(pplan, t, torch.from_numpy(src),
                              torch.from_numpy(dst), salt).numpy(),
                np.asarray(jf._edge_hash(jplan, tj, jnp.asarray(src),
                                         jnp.asarray(dst), salt)))
        for fn in ("edge_drop", "edge_dup"):
            got = getattr(pf, fn)(pplan, t, torch.from_numpy(src),
                                  torch.from_numpy(dst))
            want = getattr(jf, fn)(jplan, tj, jnp.asarray(src),
                                   jnp.asarray(dst))
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{fn} t={t}")
        # one side an int, and the KV stream
        np.testing.assert_array_equal(
            pf.edge_drop(pplan, t, torch.from_numpy(src), 5).numpy(),
            np.asarray(jf.edge_drop(jplan, tj, jnp.asarray(src), 5)))
        ids = _ids(3)
        np.testing.assert_array_equal(
            pf.kv_drop(pplan, t, torch.from_numpy(ids)).numpy(),
            np.asarray(jf.kv_drop(jplan, tj, jnp.asarray(ids))))
        np.testing.assert_array_equal(
            pf.host_edge_drop(pplan, t, src, dst[None, :]),
            jf.host_edge_drop(jplan, t, src, dst[None, :]))
        np.testing.assert_array_equal(pf.host_kv_ok(pplan, t),
                                      jf.host_kv_ok(jplan, t))


@pytest.mark.parametrize("dup", (False, True))
def test_coin_block_matches_reference(dup):
    js, ps = _specs(SPECS["crash_loss_dup"])
    jplan, pplan = js.compile(), ps.compile(device="cpu")
    src = _ids(4, (10,))
    for t in (0, 3, 9, 12):
        for lo, block in ((0, 8), (13, 5)):
            want = jf.coin_block(jplan, jnp.int32(t), jnp.asarray(src),
                                 jnp.int32(lo), block, dup=dup)
            got = pf.coin_block(pplan, t, torch.from_numpy(src), lo, block,
                                dup=dup)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ("crash", "membership", "empty",
                                  "crash_loss_dup"))
def test_liveness_and_amnesia_match_reference(name):
    js, ps = _specs(SPECS[name])
    jplan, pplan = js.compile(), ps.compile(device="cpu")
    ids = np.concatenate([np.arange(N), _ids(5, (40,))])
    ids_t = torch.from_numpy(ids)
    for t in range(0, 11):
        tj = jnp.int32(t)
        for fn in ("node_up", "member_at", "amnesia"):
            np.testing.assert_array_equal(
                getattr(pf, fn)(pplan, t, ids_t).numpy(),
                np.asarray(getattr(jf, fn)(jplan, tj, jnp.asarray(ids))),
                err_msg=f"{fn} t={t}")
        np.testing.assert_array_equal(pf.host_node_up(pplan, t),
                                      jf.host_node_up(jplan, t))
        np.testing.assert_array_equal(pf.host_member_at(pplan, t),
                                      jf.host_member_at(jplan, t))
    assert int(pf.plan_churn(pplan)) == int(jf.plan_churn(jplan))


def test_amnesia_at_round_zero_reads_round_minus_one():
    # a window starting at 0 wipes at t = 0 (up at round -1); a joiner
    # wipes at its join round, a leaver never
    spec = dict(n_nodes=6, crash=((0, 2, (1,)),), join=((3, (2,)),),
                leave=((2, (4,)),))
    js, ps = _specs(spec)
    for t in (0, 1, 2, 3):
        got = pf.amnesia(ps.compile(device="cpu"), t, torch.arange(6))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf.amnesia(
            js.compile(), jnp.int32(t), jnp.arange(6))))
    assert pf.amnesia(ps.compile(device="cpu"), 0,
                      torch.arange(6)).tolist() == [False, True, False,
                                                    False, False, False]


def test_membership_sentinels():
    plan = pf.NemesisSpec(n_nodes=4).compile(device="cpu")
    assert plan.join_round.tolist() == [pf.JOIN_FOUNDING] * 4
    assert plan.leave_round.tolist() == [pf.LEAVE_NEVER] * 4
    assert (pf.JOIN_FOUNDING, pf.LEAVE_NEVER, pf.KV_DST) \
        == (jf.JOIN_FOUNDING, jf.LEAVE_NEVER, jf.KV_DST)
    assert (pf._SALT_LOSS, pf._SALT_DUP) == (jf._SALT_LOSS, jf._SALT_DUP)
    for t in (-(2**31), 0, 2**31 - 2):
        assert bool(pf.member_at(plan, t, torch.arange(4)).all())


def test_compile_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pf.NemesisSpec(n_nodes=4).compile()
