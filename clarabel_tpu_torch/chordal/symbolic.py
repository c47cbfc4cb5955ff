"""Symbolic graph analysis for chordal decomposition.

A copy of `clarabel_tpu/chordal/symbolic.py` over the port's cone classes.
Setup-time graph algorithmics (host-side; this is pointer-chasing work that
belongs on the CPU, emitting a static plan the device executes):

* minimum-degree fill-reducing ordering (replacing the reference's AMD
  ordering obtained through QDLDL, reference: chordal_info.jl:221-252);
* elimination tree + symbolic Cholesky factor pattern (the chordal
  extension L);
* `connect_graph` fix-up for disconnected patterns
  (reference: chordal_info.jl:255-279).
"""

from typing import List, Set, Tuple

import numpy as np


def minimum_degree_ordering(adj: List[Set[int]]) -> np.ndarray:
    """Greedy minimum-degree ordering of an undirected graph.

    `adj[i]` is the neighbor set of vertex i (no self loops).  Returns a
    permutation `perm` with perm[k] = vertex eliminated at step k.
    Fill edges are added as vertices are eliminated.
    """
    n = len(adj)
    adj = [set(s) for s in adj]
    alive = np.ones(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)

    for k in range(n):
        # pick min-degree vertex (ties -> smallest index, deterministic)
        best, best_deg = -1, None
        for v in range(n):
            if alive[v]:
                d = len(adj[v])
                if best_deg is None or d < best_deg:
                    best, best_deg = v, d
        v = best
        perm[k] = v
        alive[v] = False
        neighbors = [u for u in adj[v] if alive[u]]
        # connect neighbors into a clique (fill)
        for i, u in enumerate(neighbors):
            adj[u].discard(v)
            for w in neighbors[i + 1:]:
                adj[u].add(w)
                adj[w].add(u)
        adj[v].clear()
    return perm


def symbolic_cholesky(adj: List[Set[int]], perm: np.ndarray):
    """Symbolic Cholesky of the permuted pattern.

    Returns Lcols: list over columns j (in the permuted ordering, 0-based)
    of the sorted below-diagonal row patterns of L.

    Uses the standard column-merge recurrence
       L(:,j) = A(:,j)_perm ∪ ( ∪_{k : parent(k)=j} L(:,k) \\ {j} )
    """
    n = len(adj)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)

    # permuted adjacency (below-diagonal only)
    Acols = [set() for _ in range(n)]
    for v in range(n):
        jv = iperm[v]
        for u in adj[v]:
            ju = iperm[u]
            if ju > jv:
                Acols[jv].add(ju)

    Lcols: List[Set[int]] = [set() for _ in range(n)]
    children: List[List[int]] = [[] for _ in range(n)]
    parent = np.full(n, -1, dtype=np.int64)

    for j in range(n):
        patt = set(Acols[j])
        for c in children[j]:
            patt |= Lcols[c]
        patt.discard(j)
        Lcols[j] = patt
        if patt:
            p = min(patt)
            parent[j] = p
            children[p].append(j)
    return [sorted(c) for c in Lcols], parent


def connect_graph(Lcols: List[List[int]]) -> List[List[int]]:
    """Ensure L's adjacency is connected: a column j < n-1 with no
    below-diagonal entry gets an edge to j+1.
    reference: chordal_info.jl:255-279"""
    n = len(Lcols)
    out = [list(c) for c in Lcols]
    for j in range(n - 1):
        if not any(r > j for r in out[j]):
            out[j] = sorted(set(out[j]) | {j + 1})
    return out


def find_graph(nz_mask: np.ndarray, n: int):
    """From the aggregate triu-svec sparsity mask of an n x n symmetric
    pattern, compute (Lcols, ordering): the symbolic chordal extension in
    permuted coordinates, plus the ordering (perm[k] = original vertex of
    permuted vertex k).  reference: chordal_info.jl:221-252"""
    adj: List[Set[int]] = [set() for _ in range(n)]
    idx = 0
    for col in range(n):
        for row in range(col + 1):
            if nz_mask[idx] and row != col:
                adj[row].add(col)
                adj[col].add(row)
            idx += 1

    # prefer the native library; fall back to pure Python
    from .. import native_symbolic

    perm = native_symbolic.min_degree_ordering_native(adj)
    Lcols = None
    if perm is not None:
        Lcols = native_symbolic.symbolic_cholesky_native(adj, perm)
    if perm is None:
        perm = minimum_degree_ordering(adj)
    if Lcols is None:
        Lcols, _ = symbolic_cholesky(adj, perm)
    Lcols = connect_graph(Lcols)
    return Lcols, perm
