"""Hand-written CUDA kernels of the tree flood, their wrappers and their
plain PyTorch versions.

Three kernels live in ``csrc/tree_flood.cu`` (its header notes what each
replaces, what bounds it on an H100 and what the design does about it):

- :func:`tree_exchange` — the k-ary tree inbox of a (W, N) payload, the
  port of the Pallas kernel in benchmarks/pallas_tree_probe.py;
- :func:`tree_flood_round` — one fused pure-flood round,
  ``new = exchange(frontier) & ~received; received |= new;
  frontier_next = new``;
- :func:`col_popcount` — per-node popcount sums ``sum_w popc(x[w, i])``.

Bitsets are ``torch.int32`` (W, N) tensors holding the reference's uint32
words bit for bit.  A wrapper takes its plain version only when its tensor
lies on the CPU; on a CUDA tensor it launches the kernel or raises.  The
kernels are compiled with ``nvcc`` on first CUDA use (never at import, so
this module imports on machines without a toolkit) into
``build/gossip_glomers_tpu_torch/`` beside the package, keyed by a hash of
the source and flags, and loaded with ``ctypes``.

:data:`LAUNCHES` counts kernel launches per wrapper (CPU calls do not
count), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_flood.cu"
BUILD_DIR = _PKG.parent / "build" / "gossip_glomers_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_WORDS = 65535            # grid.y carries the word axis

LAUNCHES = {"tree_exchange": 0, "tree_flood_round": 0, "col_popcount": 0}

_lib_handle = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ------------------------------------------------------


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (the reference's
    ``lax.population_count`` on uint32), as int32.  SWAR on the words
    widened to int64 and masked to their low 32 bits, so every shift is
    logical and no step overflows."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def col_popcount_plain(x: torch.Tensor) -> torch.Tensor:
    return popcount(x).sum(dim=0, dtype=torch.int32)


def tree_exchange_plain(payload: torch.Tensor,
                        branching: int = 4) -> torch.Tensor:
    # structured imports this module for its exchange closures
    from .structured import tree_exchange as plain

    return plain(payload, branching)


def tree_flood_round_plain(received: torch.Tensor, frontier: torch.Tensor,
                           frontier_next: torch.Tensor,
                           branching: int = 4) -> torch.Tensor:
    new = tree_exchange_plain(frontier, branching) & ~received
    received |= new
    frontier_next.copy_(new)
    return frontier_next


# -- build and load ------------------------------------------------------


def _find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def build() -> Path:
    """Compile ``csrc/tree_flood.cu`` into a shared library (once per
    source and flag hash) and return its path.  Raises if ``nvcc`` is
    missing or fails."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"tree_flood-{key}.so"
    if lib.exists():
        return lib
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the tree-flood kernels are built with the CUDA "
            "toolkit on first use of a CUDA tensor")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)          # atomic: concurrent builders agree
    return lib


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.gg_tree_exchange.argtypes = [ptr, ptr, i64, i64, i32, ptr]
        lib.gg_tree_flood_round.argtypes = [ptr, ptr, ptr, i64, i64, i32,
                                            ptr]
        lib.gg_col_popcount.argtypes = [ptr, ptr, i64, i64, ptr]
        for fn in (lib.gg_tree_exchange, lib.gg_tree_flood_round,
                   lib.gg_col_popcount):
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


# -- wrappers ------------------------------------------------------------


def _check_bitset(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be (W, N), got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True for CPU tensors (the plain path); False for CUDA tensors on
    one device; raises for anything else."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("tensors lie on different devices: "
                         f"{[str(x.device) for x in xs]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no tree-flood kernel for device {dev}")
    return False


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check_launch(w: int, branching: int) -> None:
    if w > MAX_WORDS:
        raise ValueError(f"W = {w} words exceeds the kernels' {MAX_WORDS}")
    if branching < 1:
        raise ValueError(f"branching must be >= 1, got {branching}")


def tree_exchange(payload: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """inbox[:, i] = payload[:, (i-1)//k] (0 at the root) | OR of
    payload[:, k*i+1 .. k*i+k] over the children below N."""
    _check_bitset("payload", payload)
    if _on_cpu(payload):
        return tree_exchange_plain(payload, branching)
    w, n = payload.shape
    _check_launch(w, branching)
    inbox = torch.empty_like(payload)
    if payload.numel():
        _launch("tree_exchange", _lib().gg_tree_exchange, payload.device,
                payload.data_ptr(), inbox.data_ptr(), w, n, branching)
    return inbox


def tree_flood_round(received: torch.Tensor, frontier: torch.Tensor,
                     frontier_next: torch.Tensor,
                     branching: int = 4) -> torch.Tensor:
    """One pure-flood round: ``new = tree_exchange(frontier) & ~received``,
    then ``received |= new`` IN PLACE and ``frontier_next[:] = new``.
    ``frontier_next`` must be a distinct buffer (column i reads its
    neighbours' frontier words).  Returns ``frontier_next``."""
    for name, x in (("received", received), ("frontier", frontier),
                    ("frontier_next", frontier_next)):
        _check_bitset(name, x)
    if not (received.shape == frontier.shape == frontier_next.shape):
        raise ValueError(
            f"shape mismatch: received {tuple(received.shape)}, frontier "
            f"{tuple(frontier.shape)}, frontier_next "
            f"{tuple(frontier_next.shape)}")
    on_cpu = _on_cpu(received, frontier, frontier_next)
    if _overlap(frontier_next, frontier):
        raise ValueError("frontier_next aliases frontier: the round reads "
                         "neighbours' frontier words, so it needs a second "
                         "buffer")
    if _overlap(received, frontier) or _overlap(received, frontier_next):
        raise ValueError("received must not alias either frontier buffer")
    if on_cpu:
        return tree_flood_round_plain(received, frontier, frontier_next,
                                      branching)
    w, n = received.shape
    _check_launch(w, branching)
    if received.numel():
        _launch("tree_flood_round", _lib().gg_tree_flood_round,
                received.device, received.data_ptr(), frontier.data_ptr(),
                frontier_next.data_ptr(), w, n, branching)
    return frontier_next


def col_popcount(x: torch.Tensor) -> torch.Tensor:
    """(N,) int32 per-node popcount sum over the W words."""
    _check_bitset("x", x)
    if _on_cpu(x):
        return col_popcount_plain(x)
    w, n = x.shape
    if not x.numel():
        return torch.zeros(n, dtype=torch.int32, device=x.device)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    _launch("col_popcount", _lib().gg_col_popcount, x.device,
            x.data_ptr(), out.data_ptr(), w, n)
    return out
