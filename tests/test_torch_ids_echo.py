"""Port parity for unique ids (challenge 2) and echo (challenge 1):
gossip_glomers_tpu_torch's ``UniqueIdsSim`` and ``EchoSim`` against the
JAX reference's on the CPU, round by round, on seeded numpy inputs
(tolerance 0), with the reference's own checks (all ids distinct, the
echo identity and its ledger)."""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.tpu_sim import echo as jecho
from gossip_glomers_tpu.tpu_sim import unique_ids as jids
from gossip_glomers_tpu_torch.tpu_sim import echo as pecho
from gossip_glomers_tpu_torch.tpu_sim import unique_ids as pids


@pytest.mark.parametrize("n,g", ((16, 4), (5, 1), (33, 7)))
def test_unique_ids_match_reference(n, g):
    jsim = jids.UniqueIdsSim(n, max_per_round=g, mesh=None)
    psim = pids.UniqueIdsSim(n, max_per_round=g, device="cpu")
    js, ps = jsim.init_state(), psim.init_state()
    rng = np.random.default_rng(n)
    all_ids = []
    for _ in range(8):
        counts = rng.integers(0, g + 1, n).astype(np.int32)
        js, jout = jsim.step(js, counts)
        ps, pout = psim.step(ps, counts)
        assert pout.dtype == torch.int32 and pout.shape == (n, g, 3)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        assert ps.t == int(js.t)
        np.testing.assert_array_equal(ps.minted.numpy(),
                                      np.asarray(js.minted))
        assert psim.format_ids(pout) == jsim.format_ids(jout)
        all_ids.extend(psim.format_ids(pout))
    assert len(all_ids) == len(set(all_ids)) == int(ps.minted.sum())


@pytest.mark.parametrize("n,b", ((8, 4), (3, 1), (17, 5)))
def test_echo_matches_reference(n, b):
    jsim = jecho.EchoSim(n, mesh=None)
    psim = pecho.EchoSim(n, device="cpu")
    js, ps = jsim.init_state(), psim.init_state()
    rng = np.random.default_rng(b)
    for r in range(3):
        payload = rng.integers(-2**31, 2**31, (n, b)).astype(np.int32)
        valid = rng.random((n, b)) < 0.5 if r else payload % 3 == 0
        js, jout = jsim.step(js, payload, valid)
        ps, pout = psim.step(ps, payload, valid)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        assert ps.t == int(js.t) and int(ps.msgs) == int(js.msgs)
        out = pout.numpy()
        assert (out[valid] == payload[valid]).all()
        assert (out[~valid] == -1).all()


def test_echo_ledger_wraps_at_2_32():
    sim = pecho.EchoSim(4, device="cpu")
    st = pecho.EchoState(t=0, msgs=torch.tensor(2**32 - 2))
    st, _ = sim.step(st, np.zeros((4, 1), np.int32), np.ones((4, 1), bool))
    assert int(st.msgs) == 6


def test_mesh_and_device_rules():
    for cls in (pids.UniqueIdsSim, pecho.EchoSim):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            cls(8, mesh=object(), device="cpu")


def test_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (pids.UniqueIdsSim, pecho.EchoSim):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(8)
