"""The node mesh over a ``torch.distributed`` process group.

The port of gossip_glomers_tpu/parallel/mesh.py.  JAX's ``shard_map``
body is SPMD code written once per shard; here one process runs each
shard (one rank of a process group), and a :class:`Mesh` is that group
seen from one rank: its ``size``, its ``rank``, the ``device`` its block
lives on, the ``backend``, and the collectives the engine's halo and
reduction circuits are built from (:meth:`Mesh.ppermute`,
:meth:`Mesh.all_reduce`, :meth:`Mesh.all_gather`), each counted by kind
in :attr:`Mesh.calls`.

The backend is named by the caller, never switched here:

- ``"nccl"`` when each rank has its own card;
- ``"gloo"`` on the CPU;
- ``"gloo"`` for several ranks on one card: every payload that crosses
  ranks is then copied to host memory and back (``host_staged``).

:func:`init_distributed` joins the process group from the reference's
env contract (:data:`DIST_ENV`), :func:`pick_mesh` takes the largest
power-of-two prefix of the ranks, :func:`shard_put` cuts a rank's node
block out of a host array.  The hierarchical ``("hosts", "nodes")`` mesh,
a ``words`` axis and virtual devices are not ported (ROADMAP.md Queue A
item 10): one process is one shard here.
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


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               "(ROADMAP.md Queue A item 10)")


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
        raise _unported("init_distributed(local_devices=...)")
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
    raise _unported(f"force_virtual_devices({n})")


class Mesh:
    """A 1-D ``("nodes",)`` mesh: ``group`` (a process group, None for
    the default one) seen from this rank, its blocks on ``device``.
    ``calls`` counts the collectives by kind (``ppermute``,
    ``all_reduce``, ``all_gather``); the halo exchanges make no
    ``all_gather``."""

    axis_names = ("nodes",)

    def __init__(self, group=None, *, device) -> None:
        dist = _dist()
        if not dist.is_initialized():
            raise ValueError("a Mesh needs an initialized process group "
                             "(init_distributed)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl mesh holds its blocks on a card: "
                             f"device {self.device}")
        self.host_staged = (self.backend == "gloo"
                            and self.device.type == "cuda")
        self._global = [r if group is None
                        else dist.get_global_rank(group, r)
                        for r in range(self.size)]
        self.calls = collections.Counter()

    @property
    def shape(self) -> dict:
        return {"nodes": self.size}

    @property
    def transport(self) -> str:
        return (f"{self.backend}, host-staged" if self.host_staged
                else self.backend)

    def __repr__(self) -> str:
        return (f"Mesh(nodes={self.size}, rank={self.rank}, "
                f"device={self.device}, transport={self.transport!r})")

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

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``lax.ppermute``: each ``(src, dst)`` pair sends ``x`` from
        rank src to rank dst; a rank that is no pair's destination gets
        zeros, a self-pair is a local copy.  Every send and receive is
        finished before it returns, so successive calls never pair up
        across ranks out of order."""
        self.calls["ppermute"] += 1
        me = self.rank
        srcs = [s for s, d in pairs if d == me]
        dsts = [d for s, d in pairs if s == me]
        if len(srcs) > 1:
            raise ValueError(f"rank {me} is the destination of {srcs}")
        if not srcs:
            out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        elif srcs[0] == me:
            out = x.clone(memory_format=torch.contiguous_format)
        else:
            out = None
        remote = [d for d in dsts if d != me]
        if x.numel() == 0 or (not remote and out is not None):
            return torch.zeros_like(x) if out is None else out
        dist = _dist()
        wire = self._wire(x)
        ops = [dist.P2POp(dist.isend, wire, self._global[d], self.group)
               for d in remote]
        buf = None
        if out is None:
            buf = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.irecv, buf, self._global[srcs[0]],
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out if buf is None else self._back(buf, x)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` reduced over the ranks (``sum``, ``min``
        or ``max``)."""
        dist = _dist()
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        self.calls["all_reduce"] += 1
        wire = self._wire(x)
        if wire.data_ptr() == x.data_ptr():
            wire = wire.clone()         # the reduction is in place
        dist.all_reduce(wire, red, group=self.group)
        return self._back(wire, x)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` in rank order
        (``lax.all_gather(tiled=True)``)."""
        dist = _dist()
        self.calls["all_gather"] += 1
        wire = self._wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        return self._back(torch.cat(parts, dim=dim), x)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (one call,
        counted as an ``all_gather``): the host results of the ranks'
        scenario blocks, gathered once when a batch is collected."""
        self.calls["all_gather"] += 1
        out = [None] * self.size
        _dist().all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank (counted as a
        ``broadcast``): a host verdict computed once and shared."""
        self.calls["broadcast"] += 1
        box = [obj if self.rank == src else None]
        _dist().broadcast_object_list(box, src=self._global[src],
                                      group=self.group)
        return box[0]

    def agree(self, flag: bool) -> bool:
        """True when ``flag`` is True on every rank: the host branches
        of a sharded run (convergence) are taken on this, so every rank
        takes the same one."""
        x = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=self.device)
        return bool(int(self.all_reduce(x, "min").item()))


def pick_mesh(max_axis: int | None = None, axis_name: str = "nodes", *,
              device=None) -> Mesh | None:
    """A 1-D mesh over the largest power-of-two prefix of the ranks
    (capped at ``max_axis``), or None in a world of one process (or
    without a process group).  Every rank must call it (the prefix is a
    ``new_group`` when it is not the whole world); a rank outside the
    prefix gets None.  ``device``: where the blocks live (default: CUDA,
    the current card, as :func:`.engine.resolve_device` rules)."""
    if axis_name != "nodes":
        raise _unported(f"a mesh axis {axis_name!r}")
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
    from ..tpu_sim.engine import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = None if n == world else dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return Mesh(group, device=device)


def pick_mesh_2d(hosts: int | None = None, max_axis: int | None = None,
                 axis_names: tuple = ("hosts", "nodes")):
    """The hierarchical ``(hosts, nodes)`` mesh: not ported."""
    raise _unported("pick_mesh_2d (the hosts axis)")


def shard_put(x, mesh: Mesh | None, *, axis: int = 0,
              dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """This rank's node block of the host array ``x`` along ``axis``
    (the whole array off-mesh), as a contiguous tensor on the mesh's
    device (``device`` off-mesh).  The node axis must divide evenly."""
    arr = np.asarray(x)
    if mesh is not None:
        n = arr.shape[axis]
        if n % mesh.size != 0:
            raise ValueError(f"node axis {n} does not shard evenly over "
                             f"{mesh.size} ranks")
        block = n // mesh.size
        arr = np.take(arr, np.arange(mesh.rank * block,
                                     (mesh.rank + 1) * block), axis=axis)
        device = mesh.device
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device) if device is not None else t
