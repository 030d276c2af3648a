"""Nemesis faults on PyTorch: crash/restart, message loss, duplicate
delivery and membership, compiled, seeded and replayable.

The port of gossip_glomers_tpu/tpu_sim/faults.py's host side
(:class:`NemesisSpec`, :func:`random_spec`, the numpy mirrors) and its
device evaluators (:func:`node_up`, :func:`amnesia`, the loss and dup
coins) for the node-major gather path, and of its words-major mask
compilation (:class:`WMNemesisArrays`, :func:`crash_down_rows`, the
``wm_*`` evaluators) for the structured path:

- **crash/restart**: windows of down nodes; a down node sends and receives
  nothing, and on the round its window starts its volatile state is wiped
  (an "amnesia row"), so it recovers only through anti-entropy;
- **message loss**: each directed edge drops a round's delivery with
  probability ``loss_rate``, by a stateless hash of ``(seed, round, src,
  dst)``;
- **duplicate delivery**: with probability ``dup_rate`` an edge also
  re-delivers its source's whole received set;
- **membership**: a join row is not a member before its round and enters
  empty; a leave row is down from its round on for good.

A spec compiles to a :class:`FaultPlan`.  ``t`` is a host int in the port,
so the schedule parts of the plan that the round's control flow reads
(window bounds, loss/dup horizons and thresholds, the seed) are host ints;
the per-node parts (``down``, ``join_round``, ``leave_round``) are tensors
on the plan's device.

The coins are uint32 arithmetic done on int64 tensors holding values in
[0, 2^32): every product is formed in two 16-bit halves (:func:`_mul32`)
so that no step overflows, and every ``>>`` is of a non-negative value,
hence logical.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from . import kernels
from .engine import active_windows, resolve_device, windows_fold

# distinct stream salts: loss and dup draw independent coins from the
# same (seed, t, src, dst) counter
_SALT_LOSS = 0x9E3779B9
_SALT_DUP = 0x85EBCA6B
# the KV services are not a node row; their "edge" hashes use this as
# the dst so node<->service loss draws its own stream
KV_DST = 0x7FFFFFFF

# membership sentinels: a founding row "joined" at int32 min, a row that
# never leaves "leaves" at int32 max
JOIN_FOUNDING = -(2**31)
LEAVE_NEVER = 2**31 - 1

MASK32 = 0xFFFFFFFF
# the hash's multipliers (faults.py _edge_hash and _mix32)
_K_SRC, _K_DST, _K_T = 0xC2B2AE35, 0x27D4EB2F, 0x9E3779B9
_K_MIX1, _K_MIX2 = 0x7FEB352D, 0x846CA68B


@dataclass(frozen=True)
class FaultPlan:
    """The compiled form of a :class:`NemesisSpec`: the reference's ten
    leaves.  ``starts`` / ``ends`` are host int tuples and the scalars
    host ints (the round counter is one); ``down`` (C, N) bool and
    ``join_round`` / ``leave_round`` (N,) int32 are tensors on the plan's
    device."""

    starts: tuple[int, ...]     # crash window start round (incl)
    ends: tuple[int, ...]       # crash window end round (excl)
    down: torch.Tensor          # (C, N) bool: rows down while active
    loss_num: int               # uint32: drop iff hash < loss_num
    loss_until: int             # loss active for rounds < this
    dup_num: int                # uint32: dup iff hash < dup_num
    dup_until: int
    seed: int                   # uint32: the replay key
    join_round: torch.Tensor    # (N,) int32: member from this round on
    leave_round: torch.Tensor   # (N,) int32: member strictly before this

    @property
    def n_nodes(self) -> int:
        return int(self.down.shape[1])

    def to(self, device: str | torch.device) -> "FaultPlan":
        return dataclasses.replace(
            self, down=self.down.to(device),
            join_round=self.join_round.to(device),
            leave_round=self.leave_round.to(device))


def plan_from_numpy(*, starts, ends, down, loss_num, loss_until, dup_num,
                    dup_until, seed, join_round, leave_round,
                    device: str | torch.device = "cpu") -> FaultPlan:
    """A port :class:`FaultPlan` from the reference plan's ten leaves as
    numpy arrays (``{k: np.asarray(v) for k, v in plan._asdict().items()}``),
    so that one compiled plan can drive both packages."""
    down = np.asarray(down, bool)
    starts = tuple(int(v) for v in np.asarray(starts).reshape(-1))
    ends = tuple(int(v) for v in np.asarray(ends).reshape(-1))
    if down.ndim != 2 or not len(starts) == len(ends) == down.shape[0]:
        raise ValueError(
            f"window leaves must be starts (C,), ends (C,), down (C, N); "
            f"got {len(starts)}, {len(ends)} and {down.shape}")

    def col(a) -> torch.Tensor:
        a = np.asarray(a, np.int32).reshape(-1)
        if a.shape != (down.shape[1],):
            raise ValueError(f"membership column {a.shape} is not "
                             f"({down.shape[1]},)")
        return torch.from_numpy(a.copy()).to(device)

    return FaultPlan(
        starts=starts, ends=ends,
        down=torch.from_numpy(down.copy()).to(device),
        loss_num=int(loss_num) & MASK32, loss_until=int(loss_until),
        dup_num=int(dup_num) & MASK32, dup_until=int(dup_until),
        seed=int(seed) & MASK32, join_round=col(join_round),
        leave_round=col(leave_round))


def _rate_to_num(rate: float) -> int:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    return min(2**32 - 1, int(round(rate * 2**32)))


@dataclass(frozen=True)
class NemesisSpec:
    """Host-side seeded fault spec: JSON-able (``to_meta``) and
    compilable (``compile``) to a :class:`FaultPlan`.

    ``crash``: ``(start_round, end_round, (node ids,))`` windows.
    ``loss_rate`` / ``dup_rate`` apply to every directed delivery for
    rounds ``[0, loss_until)`` / ``[0, dup_until)``; the ``until`` values
    default to the last crash-window end (a pure-loss spec must set them).
    ``join`` / ``leave``: ``((round, (node ids,)), ...)`` membership
    events, rounds >= 1, each node at most once each, a leave after its
    join.  ``clear_round`` is the first round with no fault active.
    """

    n_nodes: int
    seed: int = 0
    crash: tuple = field(default_factory=tuple)
    loss_rate: float = 0.0
    loss_until: int | None = None
    dup_rate: float = 0.0
    dup_until: int | None = None
    join: tuple = field(default_factory=tuple)
    leave: tuple = field(default_factory=tuple)

    def _until(self, explicit: int | None, rate: float) -> int:
        if explicit is not None:
            return int(explicit)
        if rate == 0.0:
            return 0
        ends = [int(e) for _s, e, _ns in self.crash]
        if not ends:
            raise ValueError(
                "a loss/dup rate with no crash windows needs an "
                "explicit loss_until/dup_until (rounds)")
        return max(ends)

    @property
    def clear_round(self) -> int:
        """First round at which every fault has cleared."""
        ends = [int(e) for _s, e, _ns in self.crash]
        mem = [int(r) for r, _ns in self.join + self.leave]
        return max([0] + ends + mem
                   + [self._until(self.loss_until, self.loss_rate),
                      self._until(self.dup_until, self.dup_rate)])

    @property
    def has_membership(self) -> bool:
        """True when the spec carries any join/leave event."""
        return bool(self.join or self.leave)

    def __post_init__(self) -> None:
        norm = []
        for start, end, nodes in self.crash:
            nodes = tuple(sorted(int(i) for i in nodes))
            if not 0 <= int(start) < int(end):
                raise ValueError(
                    f"bad crash window [{start}, {end})")
            for i in nodes:
                if not 0 <= i < self.n_nodes:
                    raise ValueError(f"crash node {i} out of range")
            norm.append((int(start), int(end), nodes))
        object.__setattr__(self, "crash", tuple(norm))
        for name in ("join", "leave"):
            events, seen = [], set()
            for r, nodes in getattr(self, name):
                nodes = tuple(sorted(int(i) for i in nodes))
                if int(r) < 1:
                    raise ValueError(
                        f"{name} round {r} must be >= 1 (round-0 "
                        "members are the founding set)")
                for i in nodes:
                    if not 0 <= i < self.n_nodes:
                        raise ValueError(
                            f"{name} node {i} out of range")
                    if i in seen:
                        raise ValueError(
                            f"node {i} appears in more than one "
                            f"{name} event")
                    seen.add(i)
                events.append((int(r), nodes))
            object.__setattr__(self, name, tuple(events))
        jr, lr = self._membership_rows()
        bad = np.nonzero(lr <= jr)[0]
        if bad.size:
            raise ValueError(
                f"node {int(bad[0])} leaves at {int(lr[bad[0]])} but "
                f"only joins at {int(jr[bad[0]])}")
        _rate_to_num(self.loss_rate)
        _rate_to_num(self.dup_rate)
        # every active rate needs a derivable horizon
        self._until(self.loss_until, self.loss_rate)
        self._until(self.dup_until, self.dup_rate)

    def _membership_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(join_round, leave_round) (N,) int32 columns with the
        founding/never sentinels."""
        jr = np.full(self.n_nodes, JOIN_FOUNDING, np.int32)
        lr = np.full(self.n_nodes, LEAVE_NEVER, np.int32)
        for r, nodes in self.join:
            jr[list(nodes)] = r
        for r, nodes in self.leave:
            lr[list(nodes)] = r
        return jr, lr

    # -- host mirrors ----------------------------------------------------

    def host_members(self, t: int) -> np.ndarray:
        """(N,) bool: the rows that are members at round ``t``."""
        jr, lr = self._membership_rows()
        return (jr <= t) & (t < lr)

    def host_up(self, t: int) -> np.ndarray:
        """(N,) bool: the rows up at round ``t`` (non-members never)."""
        up = self.host_members(t)
        for start, end, nodes in self.crash:
            if start <= t < end:
                up[list(nodes)] = False
        return up

    # -- compilation -----------------------------------------------------

    def compile(self, device: str | torch.device | None = None
                ) -> FaultPlan:
        """The :class:`FaultPlan`, its tensors on ``device`` (default
        CUDA, as the port's entry points)."""
        device = resolve_device(device)
        down = torch.zeros((len(self.crash), self.n_nodes), dtype=torch.bool)
        for w, (_start, _end, nodes) in enumerate(self.crash):
            down[w, list(nodes)] = True
        jr, lr = self._membership_rows()
        return FaultPlan(
            starts=tuple(s for s, _e, _ns in self.crash),
            ends=tuple(e for _s, e, _ns in self.crash),
            down=down.to(device),
            loss_num=_rate_to_num(self.loss_rate),
            loss_until=self._until(self.loss_until, self.loss_rate),
            dup_num=_rate_to_num(self.dup_rate),
            dup_until=self._until(self.dup_until, self.dup_rate),
            seed=self.seed & MASK32,
            join_round=torch.from_numpy(jr).to(device),
            leave_round=torch.from_numpy(lr).to(device))

    # -- checkpoint meta -------------------------------------------------

    def to_meta(self) -> dict:
        """JSON-able form: a resumed run rebuilds the identical plan."""
        return {"n_nodes": self.n_nodes, "seed": self.seed,
                "crash": [[s, e, list(ns)] for s, e, ns in self.crash],
                "loss_rate": self.loss_rate,
                "loss_until": self._until(self.loss_until,
                                          self.loss_rate),
                "dup_rate": self.dup_rate,
                "dup_until": self._until(self.dup_until, self.dup_rate),
                "join": [[r, list(ns)] for r, ns in self.join],
                "leave": [[r, list(ns)] for r, ns in self.leave]}

    @staticmethod
    def from_meta(meta: dict) -> "NemesisSpec":
        return NemesisSpec(
            n_nodes=int(meta["n_nodes"]), seed=int(meta["seed"]),
            crash=tuple((int(s), int(e), tuple(ns))
                        for s, e, ns in meta.get("crash", ())),
            loss_rate=float(meta.get("loss_rate", 0.0)),
            loss_until=meta.get("loss_until"),
            dup_rate=float(meta.get("dup_rate", 0.0)),
            dup_until=meta.get("dup_until"),
            join=tuple((int(r), tuple(ns))
                       for r, ns in meta.get("join", ())),
            leave=tuple((int(r), tuple(ns))
                        for r, ns in meta.get("leave", ())))


def random_spec(n_nodes: int, *, seed: int, horizon: int,
                n_crash_windows: int = 2, crash_frac: float = 0.25,
                crash_len: int | None = None,
                loss_rate: float = 0.0,
                dup_rate: float = 0.0) -> NemesisSpec:
    """Randomized nemesis campaign within ``[0, horizon)`` rounds, fully
    determined by ``seed`` (the reference's draws, in its order): each
    crash window takes a random ``crash_frac`` of the nodes (never all of
    them), in disjoint time segments; loss and dup run for the whole
    horizon."""
    if horizon < 2:
        raise ValueError("horizon must be >= 2 rounds")
    rng = np.random.default_rng(seed)
    n_down = max(1, min(n_nodes - 1, int(round(crash_frac * n_nodes))))
    seg = horizon / max(1, n_crash_windows)
    length = (crash_len if crash_len is not None
              else max(1, int(seg) // 2))
    windows = []
    for w in range(n_crash_windows):
        lo = max(1, int(w * seg))
        hi = max(lo + 1, int((w + 1) * seg))
        start = int(rng.integers(lo, hi))
        end = int(min(hi, start + max(1, length)))
        if end <= start:
            continue
        nodes = tuple(int(i) for i in rng.choice(
            n_nodes, size=n_down, replace=False))
        windows.append((start, end, nodes))
    return NemesisSpec(
        n_nodes=n_nodes, seed=seed, crash=tuple(windows),
        loss_rate=loss_rate, loss_until=horizon if loss_rate else None,
        dup_rate=dup_rate, dup_until=horizon if dup_rate else None)


# -- scenario-axis batching ----------------------------------------------
#
# A scenario batch runs S specs at once.  Each plan's crash-window axis is
# padded to a common count with never-active ``[0, 0)`` windows with an
# all-False down row (evaluation is unchanged: such a window is active at
# no round) and the leaves are stacked with a leading scenario axis: a
# :class:`BatchPlan`.  The window bounds and scalars stay host arrays (the
# round counter is a host int; a batch's drivers read which windows and
# streams are active at a round without a device read), ``down`` and the
# membership columns are tensors.


def _plan_window_shapes(plan: FaultPlan, where: str = "plan") -> int:
    """The crash-window count of ``plan``, once its three window leaves
    agree on it; a disagreement raises naming ``where``."""
    c = len(plan.starts)
    if plan.down.dim() != 2:
        raise ValueError(
            f"{where}: window leaves must be starts (C,), ends (C,), "
            f"down (C, N); got starts ({c},), ends ({len(plan.ends)},), "
            f"down {tuple(plan.down.shape)}")
    if len(plan.ends) != c or int(plan.down.shape[0]) != c:
        raise ValueError(
            f"{where}: window axes disagree — starts has {c} windows, "
            f"ends {len(plan.ends)}, down {int(plan.down.shape[0])}")
    return c


def pad_plan(plan: FaultPlan, n_windows: int, *,
             where: str = "plan") -> FaultPlan:
    """``plan`` with its crash-window axis padded to ``n_windows`` by
    never-active ``[0, 0)`` windows; ``where`` names the plan in errors."""
    c = _plan_window_shapes(plan, where)
    if c > n_windows:
        raise ValueError(
            f"{where} has {c} crash windows, cannot pad to {n_windows}")
    if c == n_windows:
        return plan
    pad = n_windows - c
    return dataclasses.replace(
        plan, starts=plan.starts + (0,) * pad, ends=plan.ends + (0,) * pad,
        down=torch.cat([plan.down, torch.zeros(
            (pad, plan.n_nodes), dtype=torch.bool,
            device=plan.down.device)]))


# the reference plan's leaves and dtypes, in its order
PLAN_LEAVES = (("starts", np.int32), ("ends", np.int32), ("down", np.bool_),
               ("loss_num", np.uint32), ("loss_until", np.int32),
               ("dup_num", np.uint32), ("dup_until", np.int32),
               ("seed", np.uint32), ("join_round", np.int32),
               ("leave_round", np.int32))


@dataclass(frozen=True)
class BatchPlan:
    """S padded :class:`FaultPlan` s stacked along a leading scenario
    axis: ``starts`` / ``ends`` (S, C) and the scalars (S,) host numpy
    arrays of the reference's dtypes, ``down`` (S, C, N) bool and
    ``join_round`` / ``leave_round`` (S, N) int32 tensors."""

    starts: np.ndarray
    ends: np.ndarray
    down: torch.Tensor
    loss_num: np.ndarray
    loss_until: np.ndarray
    dup_num: np.ndarray
    dup_until: np.ndarray
    seed: np.ndarray
    join_round: torch.Tensor
    leave_round: torch.Tensor

    @property
    def n_scenarios(self) -> int:
        return int(self.down.shape[0])

    @property
    def n_windows(self) -> int:
        return int(self.down.shape[1])

    @property
    def n_nodes(self) -> int:
        return int(self.down.shape[2])

    def to(self, device: str | torch.device) -> "BatchPlan":
        return dataclasses.replace(
            self, down=self.down.to(device),
            join_round=self.join_round.to(device),
            leave_round=self.leave_round.to(device))

    def leaves(self) -> dict:
        """{name: numpy array}: the reference batch plan's leaves, in its
        dtypes."""
        out = {}
        for name, dt in PLAN_LEAVES:
            v = getattr(self, name)
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            out[name] = np.asarray(v).astype(dt)
        return out

    def plan(self, i: int) -> FaultPlan:
        """Scenario ``i``'s (padded) plan."""
        return plan_from_numpy(
            device=self.down.device,
            **{k: v[i] for k, v in self.leaves().items()})

    def window_flags(self, rounds: int, device) -> torch.Tensor:
        """(rounds + 1, S, C) bool on ``device``: row k holds which crash
        windows are active at round k - 1 (row 0: round -1, which no
        window covers)."""
        return _window_flags(self.starts, self.ends, rounds, device)

    def up(self, flags: torch.Tensor, t: int) -> torch.Tensor:
        """(S, N) bool: the rows up at round ``t`` (>= -1), from
        :meth:`window_flags`' rows: one pass a padded crash window, then
        membership."""
        act = flags[t + 1]
        up = self.member(t)
        for c in range(self.n_windows):
            up = up & ~(act[:, c:c + 1] & self.down[:, c])
        return up

    def member(self, t: int) -> torch.Tensor:
        """(S, N) bool: the member rows at round ``t``."""
        return (t >= self.join_round) & (t < self.leave_round)

    def amnesia(self, flags: torch.Tensor, t: int) -> torch.Tensor:
        """(S, N) bool: the rows crashing or joining at round ``t``."""
        return (~self.up(flags, t) & self.up(flags, t - 1)) \
            | (self.join_round == t)

    def coin_table(self, rounds: int, device) -> torch.Tensor:
        """(rounds, S, 5) int64 on ``device``: row t is
        :func:`.kernels.fault_coins`' table at round t — seed, loss_num,
        dup_num, loss active, dup active (each stream below its horizon
        with a non-zero rate)."""
        t = np.arange(rounds)[:, None]
        loss = (t < self.loss_until[None]) & (self.loss_num[None] > 0)
        dup = (t < self.dup_until[None]) & (self.dup_num[None] > 0)
        s = self.n_scenarios
        tab = np.stack([np.broadcast_to(self.seed.astype(np.int64),
                                        (rounds, s)),
                        np.broadcast_to(self.loss_num.astype(np.int64),
                                        (rounds, s)),
                        np.broadcast_to(self.dup_num.astype(np.int64),
                                        (rounds, s)),
                        loss.astype(np.int64), dup.astype(np.int64)],
                       axis=-1)
        return torch.from_numpy(np.ascontiguousarray(tab)).to(device)

    def any_dup(self, t: int) -> bool:
        return bool(((t < self.dup_until) & (self.dup_num > 0)).any())


def _window_flags(starts: np.ndarray, ends: np.ndarray, rounds: int,
                  device) -> torch.Tensor:
    t = np.arange(-1, rounds)[:, None, None]
    act = (starts[None] <= t) & (t < ends[None])
    return torch.from_numpy(np.ascontiguousarray(act)).to(device)


def batch_windows(specs, n_windows: int | None = None) -> int:
    """The padded crash-window count of a batch of ``specs`` (``n_windows``
    when given, else the widest spec's), after the batch's host checks:
    at least one spec, one ``n_nodes``, ``n_windows`` no narrower than
    the widest spec."""
    if not specs:
        raise ValueError("batch_plans needs at least one spec")
    n = specs[0].n_nodes
    for sp in specs:
        if sp.n_nodes != n:
            raise ValueError(
                f"scenario batch mixes n_nodes {n} and {sp.n_nodes} "
                "(one compiled shape per batch)")
    c_max = max(len(sp.crash) for sp in specs)
    if n_windows is not None:
        if n_windows < c_max:
            raise ValueError(
                f"n_windows={n_windows} < the batch's widest crash-"
                f"window count {c_max}")
        c_max = n_windows
    return c_max


def batch_plans(specs, n_windows: int | None = None,
                device: str | torch.device | None = None) -> BatchPlan:
    """Compile, pad and stack ``specs`` into one :class:`BatchPlan` on
    ``device`` (CUDA unless given); ``n_windows`` sets the padded
    crash-window count (at least the widest spec's)."""
    specs = list(specs)
    c_max = batch_windows(specs, n_windows)
    dev = resolve_device(device)
    plans = [pad_plan(sp.compile(device="cpu"), c_max, where=f"spec {i}")
             for i, sp in enumerate(specs)]

    def host(name, dt):
        return np.array([getattr(p, name) for p in plans], dt)

    def windows(name):
        return host(name, np.int32).reshape(len(plans), c_max)

    return BatchPlan(
        starts=windows("starts"), ends=windows("ends"),
        down=torch.stack([p.down for p in plans]).to(dev),
        loss_num=host("loss_num", np.uint32),
        loss_until=host("loss_until", np.int32),
        dup_num=host("dup_num", np.uint32),
        dup_until=host("dup_until", np.int32),
        seed=host("seed", np.uint32),
        join_round=torch.stack([p.join_round for p in plans]).to(dev),
        leave_round=torch.stack([p.leave_round for p in plans]).to(dev))


def batch_churn(bp: BatchPlan) -> np.ndarray:
    """(S,) int: each scenario's membership events (:func:`plan_churn`)."""
    jr = bp.join_round.cpu().numpy()
    lr = bp.leave_round.cpu().numpy()
    return ((jr != JOIN_FOUNDING).sum(1) + (lr != LEAVE_NEVER).sum(1))


# -- device-side evaluation ---------------------------------------------


def _ids(x, device) -> torch.Tensor:
    """Node ids (a tensor or an int) as an int64 tensor.  An int is filled
    on the device, not copied there, so a round on the card never waits
    for a host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    if isinstance(x, (int, np.integer)):
        return torch.full((), int(x), dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).to(torch.int64)


def _edge_ids(src, dst) -> tuple[torch.Tensor, torch.Tensor]:
    """An edge's endpoint ids (tensors or ints) as int64 tensors on the
    device of whichever is a tensor."""
    dev = next((x.device for x in (src, dst)
                if isinstance(x, torch.Tensor)), None)
    return _ids(src, dev), _ids(dst, dev)


def member_at(plan: FaultPlan, t: int, ids) -> torch.Tensor:
    """bool, shaped like ``ids``: members at round ``t`` (joined at or
    before ``t``, not yet left)."""
    idx = _ids(ids, plan.join_round.device)
    return (t >= plan.join_round[idx]) & (t < plan.leave_round[idx])


def plan_churn(plan: FaultPlan) -> torch.Tensor:
    """() int32: the plan's membership events (join rows + leave rows)."""
    joins = (plan.join_round != JOIN_FOUNDING).sum()
    leaves = (plan.leave_round != LEAVE_NEVER).sum()
    return (joins + leaves).to(torch.int32)


def node_up(plan: FaultPlan, t: int, ids) -> torch.Tensor:
    """bool, shaped like ``ids``: which node ids are up at round ``t``
    (every active crash window folded over :func:`.engine.windows_fold`,
    then membership)."""
    idx = _ids(ids, plan.down.device)
    up = windows_fold(plan.starts, plan.ends, t,
                      lambda w, up: up & ~plan.down[w][idx],
                      torch.ones(idx.shape, dtype=torch.bool,
                                 device=idx.device))
    return up & member_at(plan, t, idx)


def amnesia(plan: FaultPlan, t: int, ids) -> torch.Tensor:
    """bool, shaped like ``ids``: the rows that crash at round ``t`` (down
    now, up at ``t - 1``; at ``t = 0`` that is round -1) or join at it —
    the rows whose volatile state is wiped."""
    idx = _ids(ids, plan.join_round.device)
    crash = ~node_up(plan, t, idx) & node_up(plan, t - 1, idx)
    return crash | (plan.join_round[idx] == t)


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """x * k mod 2^32 for int64 x in [0, 2^32): in 16-bit halves of k, so
    no product leaves int64."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _K_MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _K_MIX2)
    return x ^ (x >> 16)


def _hash32(seed: int, t: int, src, dst, salt: int) -> torch.Tensor:
    """int64 in [0, 2^32): the counter-based stream h(seed, t, src, dst,
    salt) for node ids ``src`` and ``dst`` (tensors or ints, broadcast)."""
    src, dst = _edge_ids(src, dst)
    k = ((t & MASK32) * _K_T & MASK32) ^ (seed & MASK32) ^ salt
    return _mix32(_mul32(src & MASK32, _K_SRC)
                  ^ _mul32(dst & MASK32, _K_DST) ^ k)


def _edge_hash(plan: FaultPlan, t: int, src, dst, salt: int) -> torch.Tensor:
    """int64 in [0, 2^32): the uint32 coin stream of the directed edge
    src -> dst at round ``t``."""
    return _hash32(plan.seed, t, src, dst, salt)


def _coin(plan: FaultPlan, t: int, src, dst, salt: int, until: int,
          num: int) -> torch.Tensor:
    if t >= until:                  # the stream is off: no hash to draw
        src, dst = _edge_ids(src, dst)
        return torch.zeros(torch.broadcast_shapes(src.shape, dst.shape),
                           dtype=torch.bool, device=src.device)
    return _edge_hash(plan, t, src, dst, salt) < num


def edge_drop(plan: FaultPlan, t: int, src, dst) -> torch.Tensor:
    """bool (src and dst broadcast): this round's delivery on the directed
    edge src -> dst is lost in flight (each direction its own coin)."""
    return _coin(plan, t, src, dst, _SALT_LOSS, plan.loss_until,
                 plan.loss_num)


def edge_dup(plan: FaultPlan, t: int, src, dst) -> torch.Tensor:
    """bool: this round the edge also re-delivers its source's whole
    received set (independent of the loss coin)."""
    return _coin(plan, t, src, dst, _SALT_DUP, plan.dup_until,
                 plan.dup_num)


def coin_block(plan: FaultPlan, t: int, src_ids: torch.Tensor, dst_lo: int,
               block: int, *, dup: bool = False):
    """One destination slab's coins: ``(up, drop, dup | None)`` for the
    rows ``dst_lo + [0, block)`` against the flat ``src_ids`` — ``up``
    (block,), ``drop`` / ``dup`` (block, len(src_ids)).  Stateless, so
    any slab equals the same rows of the whole-axis masks."""
    dst = dst_lo + torch.arange(block, device=src_ids.device)
    up = node_up(plan, t, dst)
    drop = edge_drop(plan, t, src_ids[None, :], dst[:, None])
    dups = edge_dup(plan, t, src_ids[None, :], dst[:, None]) if dup else None
    return up, drop, dups


def kv_drop(plan: FaultPlan, t: int, ids) -> torch.Tensor:
    """bool, shaped like ``ids``: node i's KV exchange is lost this
    round."""
    return edge_drop(plan, t, ids, KV_DST)


# -- words-major (structured-path) mask compilation ----------------------
#
# The gather path evaluates crash liveness and the loss/dup coins per
# adjacency slot.  On the structured path every delivery is a sum of
# per-DIRECTION terms with a host-known sender map, so
#
# - crash liveness becomes a host-precomputed (C, D, N) "either endpoint
#   down" mask per crash window (``down_pair``), AND-folded at round t
#   like the partition ``same`` masks;
# - the loss/dup coins become elementwise hashes of each direction's
#   sender and receiver ids (the stateless stream needs only (t, src,
#   dst)), closed forms of the receiver column (``coin_dirs``):
#   :func:`.kernels.wm_fault_coins`;
# - amnesia rows and receiver liveness become a (C, N) per-column
#   ``down`` array (:func:`wm_up_cols`).
#
# The per-direction masks are packed rows (:func:`.kernels.pack_bits`:
# (..., D, ceil(N/32)) int32), so every window fold is a word-wise AND.


@dataclass(frozen=True)
class WMNemesisArrays:
    """The words-major nemesis operand (structured.make_nemesis builds
    it), the reference's eleven leaves as tensors on one device.
    Delivery-contract rows (``exists`` / ``same`` / ``down_pair`` /
    ``src`` / ``dst``) follow structured.nemesis_dir_pairs; degree-
    contract rows (``deg_*``) follow structured.fault_dir_senders and
    drive the ledgers.  Masks are packed rows, ids int32 (the
    reference's leaves); the coins take the ids' closed forms instead
    (``coin_dirs`` / ``deg_coin_dirs``, structured.coin_dirs), right
    wherever ``exists`` holds.

    On a mesh every column-indexed leaf is cut to a rank's block of the
    node axis (:meth:`shard`, the reference's ``wm_specs(True)``): column
    i is then node ``col0 + i`` of ``n_ids``, which the coins take."""

    exists: torch.Tensor         # (D, NW) packed: delivery edges
    same: torch.Tensor           # (P, D, NW) packed: partition same-group
    down_pair: torch.Tensor      # (C, D, NW) packed: src or dst down
    src: torch.Tensor            # (D, N) int32: sender ids
    dst: torch.Tensor            # (D, N) int32: receiver ids
    coin_dirs: torch.Tensor      # (D, 4) int64: the ids' closed forms
    deg_exists: torch.Tensor     # (Dg, NW) packed: ledger edges
    deg_same: torch.Tensor       # (P, Dg, NW) packed
    deg_down_pair: torch.Tensor  # (C, Dg, NW) packed
    deg_src: torch.Tensor        # (Dg, N) int32: the ledger's ids
    deg_dst: torch.Tensor        # (Dg, N) int32
    deg_coin_dirs: torch.Tensor  # (Dg, 4) int64
    down_cols: torch.Tensor      # (C, N) bool: amnesia / receiver-up
    n_ids: int                   # the graph's nodes, whose ids the coins hash
    col0: int = 0                # the global node of column 0

    @property
    def n_nodes(self) -> int:
        """The columns: every node, or a rank's block."""
        return int(self.src.shape[1])

    def to(self, device: str | torch.device) -> "WMNemesisArrays":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def shard(self, rank: int, n_shards: int) -> "WMNemesisArrays":
        """Rank ``rank``'s block of ``n_shards``: every column-indexed
        leaf cut to the columns ``[rank B, (rank + 1) B)``, the packed
        rows repacked over the block ((..., ceil(B/32)), the layout the
        masked halo exchanges take); the plan-wide leaves (the coin
        descriptors) stay whole."""
        n = self.n_nodes
        if self.col0 or n != self.n_ids or n % n_shards:
            raise ValueError(f"{n} columns do not shard over {n_shards} "
                             "ranks (or are a block already)")
        b = n // n_shards
        cols = slice(rank * b, (rank + 1) * b)

        def packed(x: torch.Tensor) -> torch.Tensor:
            rows = kernels.unpack_bits(x.cpu(), n)[..., cols]
            return kernels.pack_bits(rows.contiguous()).to(x.device)

        def plain(x: torch.Tensor) -> torch.Tensor:
            return x[..., cols].contiguous()

        return WMNemesisArrays(
            exists=packed(self.exists), same=packed(self.same),
            down_pair=packed(self.down_pair), src=plain(self.src),
            dst=plain(self.dst), coin_dirs=self.coin_dirs,
            deg_exists=packed(self.deg_exists),
            deg_same=packed(self.deg_same),
            deg_down_pair=packed(self.deg_down_pair),
            deg_src=plain(self.deg_src), deg_dst=plain(self.deg_dst),
            deg_coin_dirs=self.deg_coin_dirs,
            down_cols=plain(self.down_cols), col0=rank * b, n_ids=n)


def crash_down_rows(spec: NemesisSpec, ids) -> np.ndarray:
    """(C, *ids.shape) bool: which of the (possibly -1-padded) node
    ``ids`` are down in each of the spec's crash windows (pad slots read
    False)."""
    ids = np.asarray(ids)
    out = np.zeros((len(spec.crash),) + ids.shape, bool)
    for c, (_s, _e, nodes) in enumerate(spec.crash):
        d = np.zeros(spec.n_nodes, bool)
        d[list(nodes)] = True
        out[c] = d[np.clip(ids, 0, spec.n_nodes - 1)] & (ids >= 0)
    return out


def wm_up_cols(plan: FaultPlan, t: int,
               down_cols: torch.Tensor) -> torch.Tensor:
    """(N,) bool: per-column liveness at round ``t`` from the (C, N)
    ``down_cols`` rows, the words-major twin of :func:`node_up`."""
    return windows_fold(plan.starts, plan.ends, t,
                        lambda c, up: up & ~down_cols[c],
                        torch.ones(down_cols.shape[1:], dtype=torch.bool,
                                   device=down_cols.device))


def wm_wipe_cols(plan: FaultPlan, t: int,
                 down_cols: torch.Tensor) -> torch.Tensor | None:
    """(N,) bool: the amnesia columns of round ``t`` (down now, up at
    ``t - 1``), or None when no crash window starts a new down set (the
    windows active at ``t`` are among those active at ``t - 1``)."""
    now = set(active_windows(plan.starts, plan.ends, t))
    if now <= set(active_windows(plan.starts, plan.ends, t - 1)):
        return None
    return ~wm_up_cols(plan, t, down_cols) & wm_up_cols(plan, t - 1,
                                                        down_cols)


def wm_live_rows(plan: FaultPlan, t: int, arrs: WMNemesisArrays, pstarts,
                 pends, *, deg: bool = False) -> torch.Tensor:
    """(D, NW) packed per-direction SEND liveness at round ``t``: exists
    AND same-group under every active partition window AND both
    endpoints up under every active crash window.  ``deg`` picks the
    degree-contract rows.  The exists rows themselves when no window is
    active."""
    exists = arrs.deg_exists if deg else arrs.exists
    same = arrs.deg_same if deg else arrs.same
    down_pair = arrs.deg_down_pair if deg else arrs.down_pair
    lv = windows_fold(pstarts, pends, t, lambda w, lv: lv & same[w], exists)
    return windows_fold(plan.starts, plan.ends, t,
                        lambda c, lv: lv & ~down_pair[c], lv)


def _loss_on(plan: FaultPlan, t: int) -> bool:
    return t < plan.loss_until and plan.loss_num > 0


def wm_live_del(plan: FaultPlan, t: int, arrs: WMNemesisArrays, pstarts,
                pends, dup_on: bool):
    """``(live_del, dup | None)``, packed delivery-contract rows at send
    round ``t`` under the full nemesis: the send liveness minus the loss
    coins, and the delivered edges whose dup coin fired (None where the
    dup stream is off or past its horizon at ``t``: the reference's
    all-False rows).  The coins are :func:`.kernels.wm_fault_coins`' over
    the ids' closed forms, the gather path's (t, src, dst) streams."""
    live = wm_live_rows(plan, t, arrs, pstarts, pends)
    loss = _loss_on(plan, t)
    dup = dup_on and t < plan.dup_until and plan.dup_num > 0
    if not (loss or dup):
        return live, None
    return kernels.wm_fault_coins(arrs.coin_dirs, arrs.n_nodes, live, t=t,
                                  seed=plan.seed, loss_num=plan.loss_num,
                                  dup_num=plan.dup_num, loss=loss, dup=dup,
                                  srv=False, col0=arrs.col0,
                                  n_ids=arrs.n_ids)


def wm_srv_rows(plan: FaultPlan, t: int, arrs: WMNemesisArrays, pstarts,
                pends, *, live: torch.Tensor | None = None):
    """``(live, ack, both)``: the loss-only server ledger's packed rows
    over the degree contract at round ``t``: the send liveness (requests
    charged at send time; ``live`` when the caller has it), ``ack`` the
    edges whose reply coin (dst -> src) also survives, ``both`` those
    whose two coins survive (the sync-diff pairs)."""
    if live is None:
        live = wm_live_rows(plan, t, arrs, pstarts, pends, deg=True)
    if not _loss_on(plan, t):
        return live, live, live
    ack, both = kernels.wm_fault_coins(
        arrs.deg_coin_dirs, arrs.n_nodes, live, t=t, seed=plan.seed,
        loss_num=plan.loss_num, dup_num=plan.dup_num, loss=True, dup=False,
        srv=True, col0=arrs.col0, n_ids=arrs.n_ids)
    return live, ack, both


# -- host mirrors --------------------------------------------------------


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(_K_MIX1)
    x ^= x >> np.uint32(15)
    x *= np.uint32(_K_MIX2)
    x ^= x >> np.uint32(16)
    return x


def host_member_at(plan: FaultPlan, t: int) -> np.ndarray:
    """(N,) bool: numpy twin of :func:`member_at` over every row."""
    jr = plan.join_round.cpu().numpy()
    lr = plan.leave_round.cpu().numpy()
    return (jr <= t) & (t < lr)


def host_node_up(plan: FaultPlan, t: int) -> np.ndarray:
    """(N,) bool: numpy twin of :func:`node_up` over every row."""
    up = host_member_at(plan, t)
    down = plan.down.cpu().numpy()
    for w, (start, end) in enumerate(zip(plan.starts, plan.ends)):
        if start <= t < end:
            up = up & ~down[w]
    return up


def host_edge_drop(plan: FaultPlan, t: int, src, dst) -> np.ndarray:
    """numpy twin of :func:`edge_drop`: bit-identical coins."""
    src = np.asarray(src, np.int64).astype(np.uint32)
    dst = np.asarray(dst, np.int64).astype(np.uint32)
    t_term = np.uint32((int(t) * _K_T) & MASK32)
    x = (src * np.uint32(_K_SRC)
         ^ dst * np.uint32(_K_DST)
         ^ t_term ^ np.uint32(plan.seed) ^ np.uint32(_SALT_LOSS))
    return ((t < int(plan.loss_until))
            & (_mix32_np(x) < np.uint32(plan.loss_num)))


def host_kv_ok(plan: FaultPlan, t: int) -> np.ndarray:
    """(N,) bool: up and this round's KV exchange not lost."""
    ids = np.arange(plan.n_nodes)
    return host_node_up(plan, t) & ~host_edge_drop(
        plan, t, ids, np.full(plan.n_nodes, KV_DST))
