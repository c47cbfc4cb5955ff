"""Clique merge strategies for chordal decomposition.

Reimplements the reference's three merge strategies
(reference: src/chordal/merge_strategy/):

* "none"         — keep the raw supernodal cliques (nomerge.jl)
* "parent_child" — COSMO-style fill/size thresholds t_fill = t_size = 8
                   (parent_child.jl)
* "clique_graph" — default; reduced clique graph with cubic edge weights
                   n1³ + n2³ − n_merged³, greedy positive-weight merging,
                   clique-tree recovery via maximum-weight spanning tree
                   (clique_graph.jl; Garstka, Cannon & Goulart 2019)

A copy of `clarabel_tpu/chordal/merge.py`.
"""

from typing import Dict, List, Set, Tuple

import numpy as np

from .sntree import SuperNodeTree, NO_PARENT, INACTIVE, _post_order, _children_from_parent


def merge_cliques(method: str, t: SuperNodeTree) -> None:
    if t.n_cliques <= 1:
        return
    if method in ("none", "nomerge"):
        return
    if method == "parent_child":
        _merge_parent_child(t)
    elif method == "clique_graph":
        _merge_clique_graph(t)
    else:
        raise ValueError(f"unknown merge strategy: {method}")


# ---------------------------------------------------------------------------
# parent-child strategy (reference: merge_strategy/parent_child.jl)
# ---------------------------------------------------------------------------

def _merge_parent_child(t: SuperNodeTree, t_fill: int = 8, t_size: int = 8):
    snode = [set(s) for s in t.snode]
    seps = [set(s) for s in t.separators]
    children = [set(c) for c in t.snode_children]
    parent = t.snode_parent.copy()

    for clique_index in range(len(t.snode) - 2, -1, -1):
        ch = t.snode_post[clique_index]
        p = parent[ch]
        if p in (NO_PARENT, INACTIVE):
            continue
        dim_par_snode, dim_par_sep = len(snode[p]), len(seps[p])
        dim_cl_snode, dim_cl_sep = len(snode[ch]), len(seps[ch])
        fill = (dim_par_snode + dim_par_sep - dim_cl_sep) * (
            dim_cl_snode + dim_cl_sep - dim_cl_sep
        )
        max_snode = max(dim_cl_snode, dim_par_snode)
        if fill <= t_fill or max_snode <= t_size:
            # merge child into parent (reference: parent_child.jl:52-85)
            snode[p] |= snode[ch]
            snode[ch] = set()
            seps[ch] = set()
            for grandch in children[ch]:
                parent[grandch] = p
            parent[ch] = INACTIVE
            children[p].discard(ch)
            children[p] |= children[ch]
            children[ch] = set()
            t.n_cliques -= 1
            if t.n_cliques == 1:
                break

    t.snode = [sorted(s) for s in snode]
    t.separators = [sorted(s) for s in seps]
    t.snode_parent = parent
    t.snode_children = [sorted(c) for c in children]
    t.snode_post = _post_order(parent, [list(c) for c in children], t.n_cliques)


# ---------------------------------------------------------------------------
# clique-graph strategy (reference: merge_strategy/clique_graph.jl)
# ---------------------------------------------------------------------------

def _edge_metric(c1: Set[int], c2: Set[int]) -> int:
    n1, n2 = len(c1), len(c2)
    nm = len(c1 | c2)
    return n1**3 + n2**3 - nm**3


def _merge_clique_graph(t: SuperNodeTree):
    # give up the tree: supernodes absorb separators to become full cliques
    cliques: List[Set[int]] = [
        set(s) | set(sep) for s, sep in zip(t.snode, t.separators)
    ]
    n0 = len(cliques)

    # reduced clique graph edges (union of all clique trees)
    edges = _compute_reduced_clique_graph(
        [set(s) for s in t.separators], cliques
    )
    weights: Dict[Tuple[int, int], int] = {}
    adjacency: Dict[int, Set[int]] = {i: set() for i in range(n0)}
    for (r, c) in edges:
        weights[(r, c)] = _edge_metric(cliques[r], cliques[c])
        adjacency[r].add(c)
        adjacency[c].add(r)

    # greedy merging of permissible positive-weight edges
    while weights:
        # pick the highest-weight permissible edge
        order = sorted(weights.items(), key=lambda kv: -kv[1])
        edge = None
        for (r, c), w in order:
            if _is_permissible((r, c), adjacency, cliques):
                edge = (r, c)
                break
        if edge is None:
            break
        if weights[edge] < 0:
            break
        c1, c2 = edge  # merge c2 into c1

        cliques[c1] |= cliques[c2]
        cliques[c2] = set()
        t.n_cliques -= 1
        if t.n_cliques == 1:
            break

        # update graph (reference: clique_graph.jl:128-185)
        neighbors = set(adjacency[c1])
        new_neighbors = adjacency[c2] - neighbors - {c1}
        for n_ind in neighbors:
            if n_ind != c2:
                key = (max(c1, n_ind), min(c1, n_ind))
                weights[key] = _edge_metric(cliques[c1], cliques[n_ind])
        for n_ind in new_neighbors:
            key = (max(c1, n_ind), min(c1, n_ind))
            weights[key] = _edge_metric(cliques[c1], cliques[n_ind])
        # remove edges touching c2
        for key in [k for k in weights if c2 in k]:
            del weights[key]
        adjacency[c1] |= new_neighbors
        for nn in new_neighbors:
            adjacency[nn].add(c1)
        del adjacency[c2]
        for s in adjacency.values():
            s.discard(c2)
        adjacency[c1].discard(c2)

    # post-process: rebuild a clique tree from the merged graph
    t.snode = [sorted(c) for c in cliques]
    t.separators = [[] for _ in cliques]
    t.snode_parent = np.full(len(cliques), INACTIVE, dtype=np.int64)
    t.snode_post = np.asarray(
        [i for i, c in enumerate(cliques) if c], dtype=np.int64
    )
    if t.n_cliques > 1:
        _clique_tree_from_graph(t, weights, adjacency)
    else:
        # single clique: make it the root
        root = int(t.snode_post[0])
        t.snode_parent[root] = NO_PARENT
        t.snode_children = _children_from_parent(t.snode_parent)


def _compute_reduced_clique_graph(
    separators: List[Set[int]], cliques: List[Set[int]]
) -> List[Tuple[int, int]]:
    """reference: clique_graph.jl:262-295 (Habib & Stacho)"""
    edges: List[Tuple[int, int]] = []
    seen = set()
    for separator in sorted(separators, key=len, reverse=True):
        clique_indices = [
            i for i, c in enumerate(cliques) if separator and separator <= c
        ]
        if len(clique_indices) < 2:
            continue
        # separator graph H: edge between cliques whose intersection
        # strictly contains the separator
        H: Dict[int, List[int]] = {v: [] for v in clique_indices}
        for a in range(len(clique_indices)):
            for b in range(a + 1, len(clique_indices)):
                ca, cb = clique_indices[a], clique_indices[b]
                if (cliques[ca] & cliques[cb]) != separator:
                    H[ca].append(cb)
                    H[cb].append(ca)
        components = _find_components(H, clique_indices)
        comp_of = {}
        for ci, comp in enumerate(components):
            for v in comp:
                comp_of[v] = ci
        for a in range(len(clique_indices)):
            for b in range(a + 1, len(clique_indices)):
                ca, cb = clique_indices[a], clique_indices[b]
                if comp_of[ca] != comp_of[cb]:
                    key = (max(ca, cb), min(ca, cb))
                    if key not in seen:
                        seen.add(key)
                        edges.append(key)
    return edges


def _find_components(H: Dict[int, List[int]], vertices: List[int]):
    visited = {v: False for v in vertices}
    components = []
    for v in vertices:
        if not visited[v]:
            comp = set()
            stack = [v]
            visited[v] = True
            while stack:
                u = stack.pop()
                comp.add(u)
                for w in H[u]:
                    if not visited[w]:
                        visited[w] = True
                        stack.append(w)
            components.append(comp)
    return components


def _is_permissible(edge, adjacency, cliques) -> bool:
    """An edge is permissible if for every common neighbor N:
    C1 ∩ N == C2 ∩ N.  reference: clique_graph.jl:427-444"""
    c1, c2 = edge
    for nb in adjacency[c1] & adjacency[c2]:
        if (cliques[c1] & cliques[nb]) != (cliques[c2] & cliques[nb]):
            return False
    return True


def _clique_tree_from_graph(t: SuperNodeTree, weights, adjacency):
    """Maximum-weight spanning tree (Kruskal) over clique intersections,
    then split cliques into supernodes + separators.
    reference: clique_graph.jl:214-240, 520-677"""
    cliques = [set(s) for s in t.snode]

    # intersection weights on surviving edges
    edge_list = []
    for (r, c) in weights:
        if cliques[r] and cliques[c]:
            edge_list.append(((r, c), len(cliques[r] & cliques[c])))
    edge_list.sort(key=lambda kv: -kv[1])

    # Kruskal max spanning tree via union-find
    parent_uf = list(range(len(cliques)))

    def find(x):
        while parent_uf[x] != x:
            parent_uf[x] = parent_uf[parent_uf[x]]
            x = parent_uf[x]
        return x

    mst = set()
    found = 0
    for (r, c), w in edge_list:
        rr, rc = find(r), find(c)
        if rr != rc:
            parent_uf[rr] = rc
            mst.add((r, c))
            found += 1
            if found >= t.n_cliques - 1:
                break

    # root = clique containing the highest-ordered vertex
    v = int(t.post[-1])
    root = next(k for k, c in enumerate(cliques) if v in c)
    snode_parent = np.full(len(cliques), INACTIVE, dtype=np.int64)
    snode_parent[root] = NO_PARENT

    # assign children along MST
    children = [[] for _ in cliques]
    stack = [root]
    while stack:
        c = stack.pop()
        for n in sorted(adjacency.get(c, ())):
            key = (max(c, n), min(c, n))
            if key in mst and snode_parent[c] != n:
                snode_parent[n] = c
                children[c].append(n)
                stack.append(n)

    t.snode_parent = snode_parent
    t.snode_children = children
    t.snode_post = _post_order(snode_parent, children, t.n_cliques)

    # split cliques into supernodes and separators
    # (reference: clique_graph.jl:658-677)
    separators = [[] for _ in cliques]
    snode = [sorted(c) for c in cliques]
    for j in range(t.n_cliques - 1):
        c_ind = int(t.snode_post[j])
        p_ind = int(snode_parent[c_ind])
        sep = cliques[c_ind] & cliques[p_ind]
        separators[c_ind] = sorted(sep)
        snode[c_ind] = sorted(cliques[c_ind] - sep)
    t.snode = snode
    t.separators = separators
