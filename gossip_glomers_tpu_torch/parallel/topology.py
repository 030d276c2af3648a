"""Topology builders: adjacency lists for clusters of N nodes.

Copies of the builders the port needs from
gossip_glomers_tpu/parallel/topology.py (the port imports nothing of the
JAX package); tests hold them equal to the originals.
"""

from __future__ import annotations

import math

import numpy as np


def tree(n: int, branching: int = 4) -> list[list[int]]:
    """k-ary tree (Maelstrom's ``tree4`` shape for k=4): node i's parent
    is (i-1)//k; neighbors are parent + children."""
    adj: list[list[int]] = [[] for _ in range(n)]
    for i in range(1, n):
        parent = (i - 1) // branching
        adj[i].append(parent)
        adj[parent].append(i)
    return adj


def grid_cols(n: int) -> int:
    """Column count of the n-node grid — shared by the adjacency builder
    and the structured exchange so they can never disagree."""
    return max(1, math.isqrt(n - 1) + 1) if n > 1 else 1


def grid(n: int, cols: int | None = None) -> list[list[int]]:
    """2D grid (Maelstrom's default broadcast topology): ceil(sqrt(n))
    columns by default, neighbors up/down/left/right."""
    cols = cols or grid_cols(n)
    adj: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        r, c = divmod(i, cols)
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            rr, cc = r + dr, c + dc
            j = rr * cols + cc
            if rr >= 0 and cc >= 0 and cc < cols and 0 <= j < n:
                adj[i].append(j)
    return adj


def ring(n: int) -> list[list[int]]:
    if n == 1:
        return [[]]
    if n == 2:
        return [[1], [0]]
    return [[(i - 1) % n, (i + 1) % n] for i in range(n)]


def line(n: int) -> list[list[int]]:
    adj: list[list[int]] = [[] for _ in range(n)]
    for i in range(n - 1):
        adj[i].append(i + 1)
        adj[i + 1].append(i)
    return adj


def full(n: int) -> list[list[int]]:
    return [[j for j in range(n) if j != i] for i in range(n)]


def circulant(n: int, strides: list[int]) -> np.ndarray:
    """Circulant graph: node i's neighbors are i ± s (mod n) for each
    stride s — an expander with O(log n) diameter for a few random-ish
    strides, delivered by the structured exchange as pure rotations.
    Returns an (n, 2*len(strides)) int32 padded-neighbor array for the
    gather path."""
    cols = []
    for s in strides:
        s = s % n
        idx = np.arange(n, dtype=np.int64)
        cols.append((idx + s) % n)
        cols.append((idx - s) % n)
    return np.stack(cols, axis=1).astype(np.int32)


def expander_strides(n: int, degree: int = 8, seed: int = 0) -> list[int]:
    """Pseudo-random distinct strides in [1, n//2) for a circulant
    expander of the given (even) degree.  For even n the stride n/2 maps
    i+s and i-s to the same node, so it is taken only when no other
    distinct stride remains (n=8, degree=8 has only 4 strides)."""
    rng = np.random.default_rng(seed)
    half = max(1, n // 2)
    pair_max = half - 1 if (n % 2 == 0 and half > 1) else half
    want = min(max(1, degree // 2), half)
    strides: set[int] = {1}
    while len(strides) < want and len(strides) < pair_max:
        strides.add(int(rng.integers(2, pair_max + 1)))
    if len(strides) < want:
        strides.add(half)  # sole remaining distinct stride (even n)
    return sorted(strides)


def random_regular(n: int, degree: int, seed: int = 0) -> np.ndarray:
    """Directed random graph with out-degree exactly ``degree``, built
    from ``degree`` seeded permutations (each contributes in-degree
    exactly 1 per node; fixed points are cycled among themselves, a
    single one swaps with its successor, so there are no self-loops).
    Returns an (n, degree) int32 array of neighbor indices."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(degree):
        perm = rng.permutation(n)
        fixed = np.flatnonzero(perm == np.arange(n))
        if len(fixed) == 1 and n > 1:
            j = (fixed[0] + 1) % n
            perm[[fixed[0], j]] = perm[[j, fixed[0]]]
        elif len(fixed) > 1:
            perm[fixed] = np.roll(perm[fixed], 1)
        cols.append(perm)
    return np.stack(cols, axis=1).astype(np.int32)


def to_padded_neighbors(adj: list[list[int]],
                        fill: int = -1) -> np.ndarray:
    """Adjacency list → (n, max_degree) int32 array padded with ``fill``."""
    n = len(adj)
    deg = max((len(a) for a in adj), default=0)
    out = np.full((n, max(deg, 1)), fill, dtype=np.int32)
    for i, nbrs in enumerate(adj):
        out[i, :len(nbrs)] = nbrs
    return out
