"""Round drivers: the port of gossip_glomers_tpu/tpu_sim/engine.py's loop
combinators (``fori_rounds``, ``while_converge``, ``stepwise_converge``)
as Python loops — PyTorch runs eagerly, so each round is a few kernel
launches and the loop itself stays on the host — and of its
windows-as-data fault schedule fold (``windows_fold``)."""

from __future__ import annotations

from typing import Callable, Sequence


def fori_rounds(round_fn: Callable, state, rounds: int):
    """Exactly ``rounds`` rounds — the fixed-trip driver."""
    for _ in range(rounds):
        state = round_fn(state)
    return state


def while_converge(round_fn: Callable, converged: Callable, state,
                   limit: int):
    """Run to convergence: tests ``converged`` BEFORE the first round (an
    already converged state runs no round) and after each one, and stops
    once ``state.t`` reaches ``limit``."""
    done = converged(state)
    while not done and state.t < limit:
        state = round_fn(state)
        done = converged(state)
    return state


def stepwise_converge(step: Callable, converged: Callable, state,
                      max_rounds: int, check_every: int = 1):
    """The host-driven convergence loop: always runs at least one batch
    of ``check_every`` rounds, then checks.  Returns (final state,
    rounds run)."""
    rounds = 0
    while rounds < max_rounds:
        for _ in range(check_every):
            state = step(state)
            rounds += 1
        if converged(state):
            break
    return state, rounds


def active_windows(starts: Sequence[int], ends: Sequence[int],
                   t: int) -> list[int]:
    """The windows ``w`` with ``starts[w] <= t < ends[w]``."""
    return [w for w, (lo, hi) in enumerate(zip(starts, ends))
            if lo <= t < hi]


def windows_fold(starts: Sequence[int], ends: Sequence[int], t: int,
                 body: Callable, init):
    """Fold a windows-as-data fault schedule at round ``t``: ``carry =
    body(w, carry)`` for every window active at ``t``, in window order.
    The reference folds every window with a traced ``active`` flag
    (``body(w, active, carry)``); here ``t`` is a host int, so the active
    set is computed on the host and an inactive window costs nothing.
    No active window returns ``init`` itself."""
    carry = init
    for w in active_windows(starts, ends, t):
        carry = body(w, carry)
    return carry
