"""The port's CUDA kernels on the card: each one against its plain PyTorch
version, and the GPU simulator against the CPU one, bit for bit
(tolerance 0: bitsets and counts).

Every test here needs a CUDA card and skips without one.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu_torch.tpu_sim import broadcast, kernels, timing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _bits(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         device=device, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 5, 4097, (1 << 16) + 3))
@pytest.mark.parametrize("w", (1, 8, 32, 128))
def test_cuda_kernels_match_plain(cuda_device, w, n):
    rec = _bits((w, n), 2 * n + w, cuda_device)
    fr = _bits((w, n), 2 * n + w + 1, cuda_device)
    before = dict(kernels.LAUNCHES)
    for k in (2, 4):
        assert torch.equal(kernels.tree_exchange(fr, k),
                           kernels.tree_exchange_plain(fr, k))
        got_rec, got_nxt = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round(got_rec, fr, got_nxt, k)
        want_rec, want_nxt = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round_plain(want_rec, fr, want_nxt, k)
        assert torch.equal(got_rec, want_rec)
        assert torch.equal(got_nxt, want_nxt)
    assert torch.equal(kernels.col_popcount(rec),
                       kernels.col_popcount_plain(rec))
    torch.cuda.synchronize()
    after = kernels.LAUNCHES
    assert after["tree_exchange"] == before["tree_exchange"] + 2
    assert after["tree_flood_round"] == before["tree_flood_round"] + 2
    assert after["col_popcount"] == before["col_popcount"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("srv", (False, True))
@pytest.mark.parametrize("n,nv,sync_every", [(4097, 96, 64),
                                             (4097, 96, 3)])
def test_cuda_sim_matches_cpu_sim(cuda_device, n, nv, sync_every, srv):
    inject = broadcast.make_inject(n, nv)
    states = {}
    for dev in ("cpu", cuda_device):
        sim = timing.structured_sim("tree", n, nv, sync_every=sync_every,
                                    srv_ledger=srv, branching=4, device=dev)
        fused, rounds = sim.run_fused(inject)
        state0, _ = sim.stage(inject)
        fixed = sim.run_staged_fixed(state0, rounds)
        states[str(dev)] = (rounds, broadcast.state_to_numpy(fused),
                            broadcast.state_to_numpy(fixed))
    (r_cpu, f_cpu, x_cpu), (r_gpu, f_gpu, x_gpu) = states.values()
    assert r_cpu == r_gpu
    for a, b in ((f_cpu, f_gpu), (x_cpu, x_gpu)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
