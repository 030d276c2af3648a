"""A seeded random probe of ``run_resize_campaign`` against the
reference, on the CPU, tolerance 0: 24 campaigns drawn from
``default_rng(8100 + i)`` over the three workloads, grow and shrink, a
crash window across the boundary, loss across it on some, the counter's
two flush modes, and ``kv_keys`` on some.  Each campaign's whole result
dict (it carries no wall-clock field) must equal the reference's,
whatever its verdict."""

import numpy as np
import pytest

from gossip_glomers_tpu.harness import membership as JHM
from gossip_glomers_tpu.tpu_sim import faults as JF
from gossip_glomers_tpu_torch.harness import membership as PHM
from gossip_glomers_tpu_torch.tpu_sim import faults as PF

N_CASES = 24


def draw(i: int) -> tuple:
    """(workload, spec kwargs, n_to, resize_round, campaign kwargs)."""
    rng = np.random.default_rng(8100 + i)
    wl = ("broadcast", "counter", "kafka")[i % 3]
    n = int(rng.integers(8, 13))
    grow = bool(rng.random() < 0.5)
    delta = int(rng.integers(2, 5))
    n_to = n + delta if grow else n - delta
    r = int(rng.integers(3, 9))
    if wl == "counter":
        r += n                      # past the cas drain, as the fuzzer
    lo = int(rng.integers(max(1, r - 3), r))
    rows = tuple(sorted(int(x) for x in rng.choice(
        min(n, n_to), size=int(rng.integers(1, 3)), replace=False)))
    spec = dict(n_nodes=n, seed=int(rng.integers(0, 1000)),
                crash=((lo, r + int(rng.integers(1, 4)), rows),))
    if rng.random() < 0.5:
        spec.update(loss_rate=float(rng.choice((0.05, 0.1))),
                    loss_until=r + int(rng.integers(0, 3)))
    if not grow:
        spec["leave"] = ((int(rng.integers(1, r)),
                          tuple(range(n_to, n))),)
    kw = {"max_recovery_rounds": 48}
    if rng.random() < 0.5:
        kw["kv_keys"] = int(rng.choice((64, 200)))
    if wl == "counter":
        kw["mode"] = str(rng.choice(("cas", "allreduce")))
    elif wl == "kafka":
        kw.update(n_keys=int(rng.integers(2, 5)),
                  resync_every=int(rng.integers(2, 5)))
    return wl, spec, n_to, r, kw


@pytest.mark.parametrize("i", range(N_CASES))
def test_random_resize_campaign_matches_reference(i):
    wl, spec, n_to, r, kw = draw(i)
    want = JHM.run_resize_campaign(wl, JF.NemesisSpec(**spec), n_to, r,
                                   **kw)
    got = PHM.run_resize_campaign(wl, PF.NemesisSpec(**spec), n_to, r,
                                  device="cpu", **kw)
    assert got == want
