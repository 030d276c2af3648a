"""Topology builders: adjacency lists for clusters of N nodes.

Copies of the builders the port needs from
gossip_glomers_tpu/parallel/topology.py (the port imports nothing of the
JAX package); tests hold them equal to the originals.
"""

from __future__ import annotations

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


def to_padded_neighbors(adj: list[list[int]],
                        fill: int = -1) -> np.ndarray:
    """Adjacency list → (n, max_degree) int32 array padded with ``fill``."""
    n = len(adj)
    deg = max((len(a) for a in adj), default=0)
    out = np.full((n, max(deg, 1)), fill, dtype=np.int32)
    for i, nbrs in enumerate(adj):
        out[i, :len(nbrs)] = nbrs
    return out
