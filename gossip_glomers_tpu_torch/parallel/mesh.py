"""The mesh of shards over a ``torch.distributed`` process group.

The port of gossip_glomers_tpu/parallel/mesh.py.  JAX's ``shard_map``
body is SPMD code written once per shard; here one process runs each
shard (one rank of a process group), and a :class:`Mesh` is that group
seen from one rank: its ``axis_names`` and ``shape`` (rank ``r`` sits at
the row-major coordinates of ``r`` in ``shape``), its ``size`` and
``rank``, the ``device`` its block lives on, the ``backend``, and the
collectives the engine's halo and reduction circuits are built from
(:meth:`Mesh.ppermute`, :meth:`Mesh.all_reduce`, :meth:`Mesh.all_gather`
and the object collectives), each over one axis (``axis=``: a name, a
tuple of names, or the default, the node axis) and counted by kind in
:attr:`Mesh.calls` and by kind and axis in :attr:`Mesh.calls_by_axis`.

The meshes:

- 1-D ``("nodes",)`` (:func:`pick_mesh`): one node block a rank;
- 1-D ``("words",)`` (:func:`pick_mesh` with ``axis_name="words"``): the
  node axis unsharded, the words of a bitset cut over the ranks;
- ``("nodes", "words")`` (:func:`make_mesh`): the broadcast simulator's
  node blocks cut again over their words;
- ``("hosts", "nodes")`` (:func:`pick_mesh_2d`, or :func:`make_mesh`):
  the reference's hierarchical mesh, the hosts axis outermost.  Its node
  axis is the composite ``("hosts", "nodes")``, linearized hosts-major,
  so a node shard's index is its rank in the mesh and its blocks are the
  flat mesh's; the engine runs its circuits over ``nodes`` within a host
  first and then one per-host partial over ``hosts``.

Every rank of the world builds every subgroup of every axis, in the same
order (``dist.new_group`` is collective), whether or not it is a member.

The backend is named by the caller, never switched here:

- ``"nccl"`` when each rank has its own card;
- ``"gloo"`` on the CPU;
- ``"gloo"`` for several ranks on one card: every payload that crosses
  ranks is then copied to host memory and back (``host_staged``).  A
  two-axis mesh on one card runs this way; a two-axis NCCL mesh needs a
  card a rank and is not verified on fewer than four cards.

:func:`init_distributed` joins the process group from the reference's
env contract (:data:`DIST_ENV`), :func:`shard_put` cuts a rank's block
out of a host array.  The reference's virtual devices have no
counterpart: one process is one shard here.
"""
from __future__ import annotations

import collections
import datetime
import os

import numpy as np
import torch

#: env vars read by :func:`init_distributed` (the spawn contract):
#:
#: - ``GG_COORDINATOR``  process 0's rendezvous: ``host:port`` (a TCP
#:   store) or a URL such as ``file:///path`` (a file store)
#: - ``GG_NUM_PROCS``    total process count (absent or 1: one process)
#: - ``GG_PROC_ID``      this process's rank in [0, GG_NUM_PROCS)
#: - ``GG_BACKEND``      ``gloo`` or ``nccl``: torch.distributed needs
#:   its backend named, and no code here picks one
DIST_ENV = ("GG_COORDINATOR", "GG_NUM_PROCS", "GG_PROC_ID", "GG_BACKEND")

#: how long a collective may wait for its peers before the group fails
DEFAULT_TIMEOUT_S = 60.0


def _no_virtual(what: str) -> ValueError:
    return ValueError(f"{what}: one process is one shard here, so there "
                      "are no virtual devices; start one process a "
                      "shard (dcn_worker.spawn_world)")


def _dist():
    import torch.distributed as dist

    return dist


def init_distributed(*, coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     local_devices: int | None = None) -> bool:
    """Join the process group from :data:`DIST_ENV`, keyword arguments
    overriding.  Returns True when it (newly) initialized the group,
    False in a world of one process or when the group is already up.
    ``local_devices`` (the reference's virtual-device split) raises: one
    process is one shard here."""
    if local_devices is not None:
        raise _no_virtual("init_distributed(local_devices=...)")
    if num_processes is None:
        num_processes = int(os.environ.get("GG_NUM_PROCS", "1") or 1)
    if num_processes <= 1:
        return False
    dist = _dist()
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("GG_COORDINATOR")
    if process_id is None:
        process_id = int(os.environ.get("GG_PROC_ID", "0") or 0)
    if backend is None:
        backend = os.environ.get("GG_BACKEND") or None
    if coordinator_address is None:
        raise ValueError(
            "init_distributed: GG_NUM_PROCS > 1 but no coordinator "
            "address (set GG_COORDINATOR=host:port or a file:// URL, or "
            "pass coordinator_address=)")
    if backend not in ("gloo", "nccl"):
        raise ValueError(
            f"init_distributed: backend {backend!r} — name 'gloo' (CPU, "
            "or several ranks on one card) or 'nccl' (a card a rank) "
            "through GG_BACKEND or backend=")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def force_virtual_devices(n: int = 8) -> None:
    """The reference's virtual CPU devices: one process is one shard
    here, so this raises."""
    raise _no_virtual(f"force_virtual_devices({n})")


NODES_AXIS = "nodes"
WORDS_AXIS = "words"
HOSTS_AXIS = "hosts"


class _Axis:
    """One axis (or a tuple of axes) of a mesh seen from one rank: the
    process group of the ranks that share this rank's other coordinates
    (None: a one-rank axis, or the default group when it is the whole
    world), its members' global ranks in axis order, this rank's index
    along it, and the order the group's collectives return its members
    in (torch ranks a group's members by global rank)."""

    def __init__(self, names: tuple, group, members: list, index: int):
        self.names = names
        self.label = ",".join(names)
        self.group = group
        self.members = members
        self.index = index
        self.size = len(members)
        by_global = sorted(members)
        # group rank -> axis index, when the two differ
        self.order = (None if by_global == members
                      else [members.index(g) for g in by_global])


def _axis_key(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _subgroups(shape: dict, names: tuple) -> list:
    """The mesh ranks of every subgroup along ``names`` (the ranks that
    share every other coordinate), in a fixed order."""
    axes = list(shape)
    sizes = [shape[a] for a in axes]
    idx = np.arange(int(np.prod(sizes))).reshape(sizes)
    along = [axes.index(a) for a in names]
    rest = [i for i in range(len(axes)) if i not in along]
    t = idx.transpose(rest + along).reshape(-1, int(np.prod(
        [sizes[i] for i in along])))
    return [row.tolist() for row in t]


def _axis_sets(names: tuple) -> list:
    """The axis keys a mesh of ``names`` gives its collectives: each axis
    alone, the node axis of a hierarchical mesh, and the whole mesh."""
    keys = [(a,) for a in names]
    if HOSTS_AXIS in names and NODES_AXIS in names:
        keys.append((HOSTS_AXIS, NODES_AXIS))
    if tuple(names) not in keys:
        keys.append(tuple(names))
    return keys


class Mesh:
    """A mesh of shards: ``group`` (a process group, None for the default
    one) seen from this rank, its blocks on ``device``.  Off the
    keyword arguments it is the 1-D ``("nodes",)`` mesh over the group's
    ranks in group order; :func:`make_mesh` builds the others and hands
    ``shape`` (an ordered ``{axis: extent}``), ``members`` (the mesh's
    global ranks, row-major) and ``axes`` (the subgroups of every axis,
    which every rank of the world made).

    ``calls`` counts the collectives by kind (``ppermute``,
    ``all_reduce``, ``all_gather``, ``broadcast``), ``calls_by_axis`` by
    ``(kind, axis label)``, the label the axis names joined by commas;
    the halo exchanges make no ``all_gather``."""

    def __init__(self, group=None, *, device, shape: dict | None = None,
                 members: list | None = None,
                 axes: dict | None = None) -> None:
        dist = _dist()
        if not dist.is_initialized():
            raise ValueError("a Mesh needs an initialized process group "
                             "(init_distributed)")
        self.group = group
        size = dist.get_world_size(group)
        if members is None:
            members = [r if group is None
                       else dist.get_global_rank(group, r)
                       for r in range(size)]
        if shape is None:
            shape = {NODES_AXIS: size}
        if int(np.prod(list(shape.values()))) != size \
                or len(members) != size:
            raise ValueError(f"mesh shape {shape} does not cover the "
                             f"group's {size} ranks")
        self._shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = size
        self._global = list(members)
        me = dist.get_rank()
        self.rank = self._global.index(me)
        self.coords = {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(self.rank,
                                              tuple(shape.values())))}
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl mesh holds its blocks on a card: "
                             f"device {self.device}")
        self.host_staged = (self.backend == "gloo"
                            and self.device.type == "cuda")
        full = _Axis(self.axis_names, group, self._global, self.rank)
        self._axes = {self.axis_names: full}
        for key, ax in (axes or {}).items():
            self._axes[key] = ax
        if len(self.axis_names) == 1:
            self._axes[self.axis_names] = full
        self.node_axis = ((HOSTS_AXIS, NODES_AXIS)
                          if HOSTS_AXIS in self.axis_names
                          else (NODES_AXIS,))
        if self.node_axis not in self._axes:
            # a mesh with no nodes axis (a 1-D words mesh): the node axis
            # is this rank alone
            self._axes[self.node_axis] = _Axis(self.node_axis, None,
                                               [me], 0)
        self.calls = collections.Counter()
        self.calls_by_axis = collections.Counter()

    @property
    def shape(self) -> dict:
        return dict(self._shape)

    @property
    def transport(self) -> str:
        return (f"{self.backend}, host-staged" if self.host_staged
                else self.backend)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self._shape.items())
        return (f"Mesh({dims}, rank={self.rank}, "
                f"device={self.device}, transport={self.transport!r})")

    def axis(self, axis=None) -> _Axis:
        """The :class:`_Axis` of ``axis`` (a name or a tuple of names;
        None: the node axis)."""
        key = self.node_axis if axis is None else _axis_key(axis)
        if key not in self._axes:
            raise ValueError(f"no axis {key} on a mesh of "
                             f"{self.axis_names}")
        return self._axes[key]

    def axis_size(self, axis=None) -> int:
        return self.axis(axis).size

    def axis_index(self, axis=None) -> int:
        return self.axis(axis).index

    def _count(self, kind: str, ax: _Axis, n: int = 1) -> None:
        self.calls[kind] += n
        self.calls_by_axis[(kind, ax.label)] += n

    # -- buffers crossing ranks --------------------------------------------

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous buffer of ``x`` for the transport: on the host
        when host-staged; bools travel as bytes."""
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.view(torch.uint8)
        return x.cpu() if self.host_staged else x

    def _back(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        buf = buf.to(like.device) if self.host_staged else buf
        return buf.view(torch.bool) if like.dtype == torch.bool else buf

    # -- collectives -------------------------------------------------------

    def ppermute(self, x: torch.Tensor, pairs, axis=None) -> torch.Tensor:
        """``lax.ppermute`` along ``axis``: each ``(src, dst)`` pair of
        axis indices sends ``x`` from src to dst; a rank that is no
        pair's destination gets zeros, a self-pair is a local copy.
        Every send and receive is finished before it returns, so
        successive calls never pair up across ranks out of order."""
        return self.ppermute_many([x], pairs, axis)[0]

    def ppermute_many(self, xs, pairs, axis=None) -> list:
        """:meth:`ppermute` of several tensors over the same pairs, their
        sends and receives posted together (one tag each) and waited on
        together: independent exchanges in flight at once (counted as one
        ``ppermute`` a tensor)."""
        ax = self.axis(axis)
        self._count("ppermute", ax, len(xs))
        me = ax.index
        srcs = [s for s, d in pairs if d == me]
        dsts = [d for s, d in pairs if s == me]
        if len(srcs) > 1:
            raise ValueError(f"rank {me} is the destination of {srcs}")
        remote = [d for d in dsts if d != me]
        dist = _dist()
        ops, outs, bufs = [], [], []
        for tag, x in enumerate(xs):
            if not srcs:
                out = torch.zeros_like(
                    x, memory_format=torch.contiguous_format)
            elif srcs[0] == me:
                out = x.clone(memory_format=torch.contiguous_format)
            else:
                out = None
            buf = None
            if x.numel() and (remote or out is None):
                wire = self._wire(x)
                ops += [dist.P2POp(dist.isend, wire, ax.members[d],
                                   ax.group, tag) for d in remote]
                if out is None:
                    buf = torch.empty_like(wire)
                    ops.append(dist.P2POp(dist.irecv, buf,
                                          ax.members[srcs[0]], ax.group,
                                          tag))
            elif out is None:
                out = torch.zeros_like(x)
            outs.append(out)
            bufs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [out if buf is None else self._back(buf, x)
                for out, buf, x in zip(outs, bufs, xs)]

    def all_reduce(self, x: torch.Tensor, op: str = "sum",
                   axis=None) -> torch.Tensor:
        """A new tensor: ``x`` reduced over ``axis`` (``sum``, ``min`` or
        ``max``)."""
        return self.all_reduce_many([x], op, axis)[0]

    def all_reduce_many(self, xs, op: str = "sum", axis=None) -> list:
        """:meth:`all_reduce` of several tensors, posted as ``async_op``
        works and waited on together (one ``all_reduce`` a tensor)."""
        dist = _dist()
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        ax = self.axis(axis)
        self._count("all_reduce", ax, len(xs))
        wires = []
        for x in xs:
            wire = self._wire(x)
            if wire.data_ptr() == x.data_ptr():
                wire = wire.clone()     # the reduction is in place
            wires.append(wire)
        if ax.size > 1:
            works = [dist.all_reduce(w, red, group=ax.group, async_op=True)
                     for w in wires]
            for work in works:
                work.wait()
        return [self._back(w, x) for w, x in zip(wires, xs)]

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   axis=None) -> torch.Tensor:
        """The blocks of ``axis``'s ranks concatenated along ``dim`` in
        axis order (``lax.all_gather(tiled=True)``)."""
        dist = _dist()
        ax = self.axis(axis)
        self._count("all_gather", ax)
        wire = self._wire(x)
        if ax.size == 1:
            return self._back(wire.clone(), x)
        parts = [torch.empty_like(wire) for _ in range(ax.size)]
        dist.all_gather(parts, wire, group=ax.group)
        if ax.order is not None:
            parts = [parts[ax.order.index(i)] for i in range(ax.size)]
        return self._back(torch.cat(parts, dim=dim), x)

    def all_gather_object(self, obj, axis=None) -> list:
        """Every ``axis`` rank's picklable ``obj``, in axis order (one
        call, counted as an ``all_gather``): the host results of the
        ranks' scenario blocks, gathered once when a batch is
        collected."""
        ax = self.axis(axis)
        self._count("all_gather", ax)
        out = [None] * ax.size
        if ax.size == 1:
            return [obj]
        _dist().all_gather_object(out, obj, group=ax.group)
        if ax.order is not None:
            out = [out[ax.order.index(i)] for i in range(ax.size)]
        return out

    def broadcast_object(self, obj, src: int = 0, axis=None):
        """The ``axis`` rank ``src``'s picklable ``obj`` on every rank of
        the axis (counted as a ``broadcast``): a host verdict computed
        once and shared."""
        ax = self.axis(axis)
        self._count("broadcast", ax)
        box = [obj if ax.index == src else None]
        if ax.size > 1:
            _dist().broadcast_object_list(box, src=ax.members[src],
                                          group=ax.group)
        return box[0]

    def agree(self, flag: bool) -> bool:
        """True when ``flag`` is True on every rank of the mesh: the host
        branches of a sharded run (convergence) are taken on this, so
        every rank takes the same one."""
        x = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=self.device)
        return bool(int(self.all_reduce(x, "min",
                                        self.axis_names).item()))


def _pick_device(device):
    from ..tpu_sim.engine import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape, axis_names, *, ranks=None, device=None) -> Mesh | None:
    """A mesh of ``shape`` (extents, one an axis of ``axis_names``) over
    the world ``ranks`` (default the first ``prod(shape)``), row-major:
    mesh rank ``r`` is ``ranks[r]``, at the coordinates of ``r`` in
    ``shape``.  Every rank of the world must call it, in the same order
    as every other group it makes (it builds the mesh's group and every
    subgroup of every axis); a rank outside ``ranks`` gets None.
    ``device``: where the blocks live (default: CUDA, the current card,
    as :func:`.engine.resolve_device` rules)."""
    dist = _dist()
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized process group "
                         "(init_distributed)")
    shape = tuple(int(k) for k in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != \
            len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axes "
                         f"{axis_names}")
    size = int(np.prod(shape))
    world = dist.get_world_size()
    ranks = list(range(size)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != size or len(set(ranks)) != size \
            or not all(0 <= r < world for r in ranks):
        raise ValueError(f"a {shape} mesh needs {size} distinct ranks of "
                         f"the world's {world}, got {ranks}")
    device = _pick_device(device)
    dims = dict(zip(axis_names, shape))
    whole = ranks == list(range(world))
    group = None if whole else dist.new_group(sorted(ranks))
    me = dist.get_rank()
    mine = ranks.index(me) if me in ranks else None
    axes = {}
    for key in _axis_sets(axis_names):
        if key == axis_names:
            continue
        for sub in _subgroups(dims, key):
            members = [ranks[i] for i in sub]
            g = None
            if len(members) > 1:
                g = (group if len(members) == size
                     else dist.new_group(sorted(members)))
            if mine is not None and mine in sub:
                axes[key] = _Axis(key, g, members, sub.index(mine))
    if mine is None:
        return None
    return Mesh(group, device=device, shape=dims, members=ranks, axes=axes)


def pick_mesh(max_axis: int | None = None, axis_name: str = NODES_AXIS, *,
              device=None) -> Mesh | None:
    """A 1-D mesh over the largest power-of-two prefix of the ranks
    (capped at ``max_axis``), or None in a world of one process (or
    without a process group).  ``axis_name``: ``"nodes"`` (a node block
    a rank) or ``"words"`` (the reference's 1-D words mesh: the node
    axis whole on every rank, a bitset's words cut over them).  Every
    rank must call it (the prefix is a ``new_group`` when it is not the
    whole world); a rank outside the prefix gets None.  ``device``:
    where the blocks live (default: CUDA, the current card, as
    :func:`.engine.resolve_device` rules)."""
    if axis_name not in (NODES_AXIS, WORDS_AXIS):
        raise ValueError(f"a 1-D mesh axis is 'nodes' or 'words', got "
                         f"{axis_name!r}")
    dist = _dist()
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world <= 1:
        return None
    n = 1 << (world.bit_length() - 1)
    if max_axis is not None:
        while n > max_axis:
            n >>= 1
    if n <= 1:
        return None
    return make_mesh((n,), (axis_name,), device=device)


#: each rank's host name, gathered once (:func:`host_names`)
_HOST_NAMES: list | None = None


def host_names() -> list:
    """Every rank's host name in rank order, gathered over the world the
    first time and kept: the machines a world spans."""
    global _HOST_NAMES
    if _HOST_NAMES is None:
        import socket

        dist = _dist()
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, socket.gethostname())
        _HOST_NAMES = out
    return list(_HOST_NAMES)


def pick_mesh_2d(hosts: int | None = None, max_axis: int | None = None,
                 axis_names: tuple = (HOSTS_AXIS, NODES_AXIS), *,
                 device=None) -> Mesh | None:
    """The hierarchical 2-D mesh (the reference's contract): the hosts
    axis outermost, the ranks of one host inside.

    ``hosts`` defaults to the number of machines the world spans (the
    ranks grouped by their host name, :func:`host_names`); pass it to
    fold the ranks of one machine into a simulated hierarchy, as the
    tests and the smoke do.  When ``hosts`` is that machine count each
    host's row holds its own machine's ranks, else the ranks are cut
    into ``hosts`` contiguous rows.  A row keeps the largest power of
    two of its ranks; ``max_axis`` caps the whole node-shard count
    (hosts x per host), shrinking the inner axis first.  None in a world
    of one rank, on an uneven host split, or on a cap below the host
    count.  Every rank must call it (it makes the mesh's groups); a rank
    outside the mesh gets None."""
    dist = _dist()
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    names = host_names()
    machines = list(dict.fromkeys(names))
    if hosts is None:
        hosts = max(len(machines), 1)
    if hosts < 1 or world % hosts != 0:
        return None
    if hosts > 1 and len(machines) == hosts:
        rows = [[r for r in range(world) if names[r] == m]
                for m in machines]
        per = min(len(r) for r in rows)
    else:
        per = world // hosts
        rows = [list(range(h * per, (h + 1) * per)) for h in range(hosts)]
    if per == 0:
        return None
    per = 1 << (per.bit_length() - 1)
    if max_axis is not None:
        while hosts * per > max_axis and per > 1:
            per >>= 1
        if hosts * per > max_axis:
            return None
    if hosts * per <= 1:
        return None
    ranks = [r for row in rows for r in row[:per]]
    return make_mesh((hosts, per), axis_names, ranks=ranks, device=device)


def shard_put(x, mesh: Mesh | None, *, axis: int = 0,
              dtype: torch.dtype | None = None, device=None,
              words_axis: int | None = None) -> torch.Tensor:
    """This rank's block of the host array ``x`` (the whole array
    off-mesh), as a contiguous tensor on the mesh's device (``device``
    off-mesh): its node block along ``axis`` (the node shards of the
    mesh's node axis), and on a mesh with a ``words`` axis its words
    block along ``words_axis`` when that is given.  Each cut axis must
    divide evenly."""
    arr = np.asarray(x)
    if mesh is not None:
        cuts = [(axis, mesh.axis(None))]
        if words_axis is not None and WORDS_AXIS in mesh.axis_names:
            cuts.append((words_axis, mesh.axis(WORDS_AXIS)))
        for dim, ax in cuts:
            n = arr.shape[dim]
            if n % ax.size != 0:
                raise ValueError(f"axis {n} does not shard evenly over "
                                 f"{ax.size} ranks ({ax.label})")
            block = n // ax.size
            arr = np.take(arr, np.arange(ax.index * block,
                                         (ax.index + 1) * block), axis=dim)
        device = mesh.device
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device) if device is not None else t
