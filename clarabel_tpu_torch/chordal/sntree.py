"""Supernodal elimination tree for chordal decomposition.

Host-side port-free reimplementation of the reference's SuperNodeTree
analysis (reference: src/chordal/supernode_tree.jl): elimination tree from
the chordal factor pattern L, postordering, Pothen-Sun supernode detection,
separators, consecutive-reordering for PSD completion, and block dims.

Vertices are 0-based here; `NO_PARENT` / `INACTIVE` use -1 / -2.

A copy of `clarabel_tpu/chordal/sntree.py`.
"""

from typing import List, Set

import numpy as np

NO_PARENT = -1
INACTIVE = -2


class SuperNodeTree:
    def __init__(self, Lcols: List[List[int]]):
        """Lcols[j] = sorted below-diagonal row pattern of column j of L."""
        n = len(Lcols)
        self.Lcols = Lcols

        parent = np.full(n, NO_PARENT, dtype=np.int64)
        for j in range(n):
            if Lcols[j]:
                parent[j] = Lcols[j][0]  # first below-diagonal entry
        self.vertex_parent = parent

        children = [[] for _ in range(n)]
        for v, p in enumerate(parent):
            if p != NO_PARENT:
                children[p].append(v)

        self.post = _post_order(parent, children, n)

        # higher degree |adj+(v)| (reference: supernode_tree.jl:226-233)
        degree = np.array([len(c) for c in Lcols], dtype=np.int64)

        snode, snode_parent = _find_supernodes(parent, self.post, degree)
        self.snode: List[List[int]] = snode          # supernode vertex lists
        self.snode_parent = snode_parent

        self.snode_children = _children_from_parent(self.snode_parent)
        self.snode_post = _post_order(
            self.snode_parent, self.snode_children, len(self.snode_parent)
        )

        # separators (reference: supernode_tree.jl:198-217)
        self.separators: List[List[int]] = []
        for sn in self.snode:
            if not sn:
                self.separators.append([])
                continue
            vrep = min(sn)
            snset = set(sn)
            sep = [u for u in Lcols[vrep] if u not in snset]
            self.separators.append(sorted(sep))

        self.nblk = None
        self.n_cliques = len(self.snode)

    # ------------------------------------------------------------------
    def get_snode(self, i: int) -> List[int]:
        return self.snode[self.snode_post[i]]

    def get_separators(self, i: int) -> List[int]:
        return self.separators[self.snode_post[i]]

    def get_clique_parent(self, clique_index: int) -> int:
        return self.snode_parent[self.snode_post[clique_index]]

    def get_clique(self, i: int) -> List[int]:
        c = self.snode_post[i]
        return sorted(set(self.snode[c]) | set(self.separators[c]))

    def get_clique_by_index(self, i: int) -> List[int]:
        return sorted(set(self.snode[i]) | set(self.separators[i]))

    def get_nblk(self, i: int) -> int:
        return self.nblk[i]

    def get_overlap(self, i: int) -> int:
        return len(self.separators[self.snode_post[i]])

    def get_decomposed_dim_and_overlaps(self):
        dim = 0
        overlaps = 0
        for i in range(self.n_cliques):
            dim += _tri(self.get_nblk(i))
            overlaps += _tri(self.get_overlap(i))
        return dim, overlaps

    # ------------------------------------------------------------------
    def reorder_snode_consecutively(self, ordering: np.ndarray) -> np.ndarray:
        """Renumber vertices so each supernode is a consecutive range (in
        snode_post order); updates `ordering` to keep mapping to the
        original data.  reference: supernode_tree.jl:118-161"""
        n = len(self.post)
        p = np.zeros(n, dtype=np.int64)
        k = 0
        for i in self.snode_post:
            sn = sorted(self.snode[i])
            m = len(sn)
            p[k:k + m] = sn
            self.snode[i] = list(range(k, k + m))
            k += m
        p_inv = np.empty(n, dtype=np.int64)
        p_inv[p] = np.arange(n)
        for idx, sp in enumerate(self.separators):
            self.separators[idx] = sorted(int(p_inv[x]) for x in sp)
        # new ordering: permuted-vertex -> original vertex
        return ordering[p]

    def calculate_block_dimensions(self):
        """reference: supernode_tree.jl:167-175"""
        self.nblk = np.zeros(self.n_cliques, dtype=np.int64)
        for i in range(self.n_cliques):
            c = self.snode_post[i]
            self.nblk[i] = len(self.separators[c]) + len(self.snode[c])


def _tri(k: int) -> int:
    return (k * (k + 1)) // 2


def _children_from_parent(parent: np.ndarray) -> List[List[int]]:
    children = [[] for _ in range(len(parent))]
    for v, p in enumerate(parent):
        if p not in (NO_PARENT, INACTIVE):
            children[p].append(v)
    return children


def _post_order(parent: np.ndarray, children: List[List[int]], nc: int) -> np.ndarray:
    """Descending-stack postorder (reference: supernode_tree.jl:248-279).
    Returns the first nc entries of the postorder."""
    n = len(parent)
    order = np.full(n, nc + 1, dtype=np.int64)
    roots = [v for v in range(n) if parent[v] == NO_PARENT]
    # reference takes the first root
    stack = [roots[0]] if roots else []
    i = nc - 1
    while stack:
        v = stack.pop()
        order[v] = i
        i -= 1
        stack.extend(sorted(children[v]))
    post = sorted(range(n), key=lambda x: order[x])
    return np.asarray(post[:nc], dtype=np.int64)


def _find_supernodes(parent: np.ndarray, post: np.ndarray, degree: np.ndarray):
    """Pothen-Sun supernode detection (reference: supernode_tree.jl:285-390)."""
    n = len(parent)
    snode_index = np.full(n, -1, dtype=np.int64)
    snode_parent = np.full(n, NO_PARENT, dtype=np.int64)
    children = [[] for _ in range(n)]

    roots = [v for v in range(n) if parent[v] == NO_PARENT]
    root_index = roots[0]

    for v in post:
        if parent[v] == NO_PARENT:
            children[root_index].append(v)
        else:
            children[parent[v]].append(v)

        if parent[v] != NO_PARENT:
            if degree[v] - 1 == degree[parent[v]] and snode_index[parent[v]] == -1:
                # parent belongs to the same supernode
                if snode_index[v] < 0:
                    snode_index[parent[v]] = v
                    snode_index[v] -= 1
                else:
                    snode_index[parent[v]] = snode_index[v]
                    snode_index[snode_index[v]] -= 1
            else:
                if snode_index[v] < 0:
                    snode_parent[v] = v
                else:
                    snode_parent[snode_index[v]] = snode_index[v]

        k = v if snode_index[v] < 0 else snode_index[v]
        for w in children[v]:
            l = w if snode_index[w] < 0 else snode_index[w]
            if l != k:
                snode_parent[l] = k

    repr_vertex = [v for v in range(n) if snode_index[v] < 0]
    repr_parent = snode_parent[repr_vertex]

    # re-index supernode parents into the compacted representative list
    rep_pos = {rv: i for i, rv in enumerate(repr_vertex)}
    new_parent = np.full(len(repr_vertex), NO_PARENT, dtype=np.int64)
    for i, rp in enumerate(repr_parent):
        new_parent[i] = rep_pos.get(int(rp), NO_PARENT)

    # build supernode member lists (in representative order)
    snode = [[] for _ in range(len(repr_vertex))]
    for v in range(n):
        f = snode_index[v]
        rep = v if f < 0 else int(f)
        snode[rep_pos[rep]].append(v)

    return snode, new_parent
