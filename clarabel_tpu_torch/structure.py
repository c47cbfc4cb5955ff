"""Host-side KKT structure detection for the block-arrow backend.

A copy of `clarabel_tpu/structure.py` (numpy and scipy only): given the
sparsity patterns of P and A and the cone layout, permute the augmented
KKT matrix

    K = [ P   Aᵀ ]
        [ A  −Hs ]

into single-level block-arrow form: p independent diagonal blocks plus a
dense separator tail, so the per-iteration factorization becomes p
independent small LDL factorizations, batched, plus one dense Schur
complement.

Graph model: one node per primal variable and per conic *row*, with every
cone's rows fused into a single supernode (their Hs block is dense within
the cone).  Edges from the patterns of P and A.  Partitioning is
recursive bisection, each cut the best of the spectral (Fiedler), the BFS
level-set and, with the native library (`native_symbolic.py`), the
multilevel bisection; the boundary nodes of a cut move to the separator.
`pad_plan_blocks` pads the block count to a multiple of a mesh axis's size
for the sharded factorization (`Solver(mesh=...)`).
"""

import dataclasses
from typing import List, Optional

import numpy as np

from .cones.api import nvars
from .cones.layout import ConeLayout


@dataclasses.dataclass
class BlockArrowPlan:
    """Static plan: permutation + padded block index maps into the
    permuted KKT."""
    perm: np.ndarray          # (N,) permuted order: KKT index at position i
    block_idx: np.ndarray     # (p, nb_max) indices into the ORIGINAL KKT
    #                           with out-of-range sentinel N at pads
    tail_idx: np.ndarray      # (nt,)
    block_signs: np.ndarray   # (p, nb_max) ±1 (pads +1)
    tail_signs: np.ndarray    # (nt,)
    n: int
    m: int

    @property
    def p(self) -> int:
        return self.block_idx.shape[0]

    @property
    def nb(self) -> int:
        return self.block_idx.shape[1]

    @property
    def nt(self) -> int:
        return self.tail_idx.shape[0]

    def flop_estimate(self) -> float:
        """Rough factorization flop count (for backend auto-selection,
        comparable with NestedPlan.flop_estimate)."""
        p, nb, nt = self.p, self.nb, self.nt
        return p * (nb ** 3 / 3 + nb ** 2 * nt + nb * nt ** 2) + nt ** 3 / 3

    @property
    def key(self):
        # content hash: the index arrays are baked into the built solve
        # function, so structurally different plans must not share a
        # cache entry even at equal shapes
        import hashlib

        h = hashlib.sha1()
        for a in (self.perm, self.block_idx, self.tail_idx,
                  self.block_signs, self.tail_signs):
            h.update(np.ascontiguousarray(a).tobytes())
        return (self.p, self.nb, self.nt, self.n, self.m, h.hexdigest())


def pad_plan_blocks(plan: BlockArrowPlan, multiple: int) -> BlockArrowPlan:
    """Pad the block count up to a multiple of `multiple` with
    all-sentinel (identity) blocks, so the block axis splits evenly over a
    mesh axis (reference structure.py:78-99).  Sentinel rows (index ≥ N)
    gather zeros and land on the discarded pad row; the dense and the
    map-based assembly both make all-sentinel blocks exact identities with
    zero couplings, so padded blocks contribute nothing."""
    p = plan.p
    pp = -(-p // multiple) * multiple
    if pp == p:
        return plan
    N = plan.n + plan.m
    pad = pp - p
    block_idx = np.concatenate(
        [plan.block_idx,
         np.full((pad, plan.nb), N, dtype=plan.block_idx.dtype)])
    block_signs = np.concatenate(
        [plan.block_signs,
         np.ones((pad, plan.nb), dtype=plan.block_signs.dtype)])
    return dataclasses.replace(plan, block_idx=block_idx,
                               block_signs=block_signs)


def _as_pattern(M_or_pattern):
    """Accept a dense mask array or a ((rows, cols), shape) tuple."""
    if isinstance(M_or_pattern, tuple):
        (rows, cols), shape = M_or_pattern
        return np.asarray(rows), np.asarray(cols), shape
    mask = np.asarray(M_or_pattern)
    r, c = np.nonzero(mask)
    return r, c, mask.shape


def _kkt_supernode_graph(P_pat, A_pat, layout: ConeLayout,
                         soc_rank2_min_dim=None):
    """Build the quotient graph: nodes = n variables + one node per cone
    row group.  Returns (adjacency list, node -> KKT-row lists)."""
    pi, pj, (n, _) = P_pat
    ai, aj, (m, _) = A_pat

    # map each conic row to its cone node; NN/zero rows are singletons,
    # SOC/PSD/exp/pow/genpow rows fuse per cone
    row_node = np.empty(m, dtype=np.int64)
    node_rows: List[List[int]] = [[i] for i in range(n)]  # variable nodes

    next_node = n
    ofs = 0
    for cone in layout.cones:
        k = nvars(cone)
        from .cones.api import (ZeroConeT, NonnegativeConeT,
                                SecondOrderConeT, GenPowerConeT)

        # low-rank cones (big SOC/genpow) keep only their diagonal inside
        # the factored KKT (kkt/socrank.py), so their rows need not form
        # one supernode
        lowrank = (soc_rank2_min_dim is not None
                   and isinstance(cone, (SecondOrderConeT, GenPowerConeT))
                   and k >= soc_rank2_min_dim)
        if isinstance(cone, (ZeroConeT, NonnegativeConeT)) or lowrank:
            for r in range(ofs, ofs + k):
                row_node[r] = next_node
                node_rows.append([n + r])
                next_node += 1
        else:
            rows = list(range(ofs, ofs + k))
            for r in rows:
                row_node[r] = next_node
            node_rows.append([n + r for r in rows])
            next_node += 1
        ofs += k

    nnodes = next_node
    adj: List[set] = [set() for _ in range(nnodes)]

    for i, j in zip(pi, pj):
        if i != j:
            adj[int(i)].add(int(j))
            adj[int(j)].add(int(i))
    for r, c in zip(ai, aj):
        u = int(row_node[r])
        adj[u].add(int(c))
        adj[int(c)].add(u)
    return adj, node_rows


def _bfs_order(adj, nodes):
    """BFS level-set ordering of an induced subgraph (pseudo-peripheral
    start)."""
    nodes_set = set(nodes)
    order = []
    seen = set()
    for seed in nodes:
        if seed in seen:
            continue
        queue = [seed]
        seen.add(seed)
        while queue:
            v = queue.pop(0)
            order.append(v)
            for w in sorted(adj[v]):
                if w in nodes_set and w not in seen:
                    seen.add(w)
                    queue.append(w)
    return order


def _split_order(order, adj, weights):
    """Given a vertex ordering, split at the median and form the
    separator as a greedy weighted vertex cover of the cut edges: pick
    the endpoint with the best (cut-degree / row-weight) ratio, so cheap
    hub variables absorb wide couplings instead of heavy cone supernodes
    being dragged into the separator."""
    half = len(order) // 2
    left = set(order[:half])
    right = set(order[half:])

    # cut edges
    cut = {}
    for v in right:
        for w in adj[v]:
            if w in left:
                cut.setdefault(v, set()).add(w)
                cut.setdefault(w, set()).add(v)
    sep = set()
    while True:
        best, bscore = None, 0.0
        for v, nbrs in cut.items():
            if v not in sep and nbrs:
                score = len(nbrs) / max(1, weights[v])
                if score > bscore:
                    best, bscore = v, score
        if best is None:
            break
        sep.add(best)
        for w in list(cut.get(best, ())):
            cut[w].discard(best)
        cut[best] = set()
    left -= sep
    right -= sep
    return sorted(left), sorted(right), sorted(sep)


def _spectral_order(adj, nodes):
    """Order the induced subgraph by its Fiedler vector (second Laplacian
    eigenvector) — much better cuts than BFS on general graphs.  Returns
    None when the eigensolve is unavailable or fails."""
    try:
        import scipy.sparse as sps
        import scipy.sparse.linalg as spla
    except ImportError:  # pragma: no cover
        return None
    k = len(nodes)
    if k < 16:
        return None
    pos = {v: i for i, v in enumerate(nodes)}
    rows, cols = [], []
    for v in nodes:
        for w in adj[v]:
            if w in pos:
                rows.append(pos[v])
                cols.append(pos[w])
    if not rows:
        return None
    W = sps.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(k, k)
    ).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    L = sps.diags(deg) - W

    # Fiedler vector by LOBPCG with a Jacobi preconditioner and the
    # constant vector deflated via the Y constraint.  Shift-invert
    # alternatives either crash (ARPACK/SuperLU on disconnected
    # Laplacians) or cannot separate λ₂ from the cluster of small
    # eigenvalues on chain/mesh graphs (any safe shift σ ≫ λ₂ ≈ π²/k²).
    # Every failure path returns None → BFS level-set ordering, and
    # _bisect keeps whichever ordering cuts better anyway.
    rng_x = np.cos(np.arange(k) * 0.37) + 0.1
    X = rng_x.reshape(-1, 1)
    Y = np.ones((k, 1))
    Minv = sps.diags(1.0 / np.maximum(deg + 1e-3, 1e-3))
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vals, vecs = spla.lobpcg(
                L, X, Y=Y, M=Minv, largest=False,
                maxiter=min(500, 4 * int(np.sqrt(k)) + 50), tol=1e-6,
            )
    except Exception:  # pragma: no cover - solver-internal failures
        return None
    x = vecs[:, 0]
    if not np.all(np.isfinite(x)) or np.linalg.norm(x) == 0:
        return None
    return [nodes[i] for i in np.argsort(x)]


def _multilevel_candidate(adj, nodes, weights):
    """Native METIS-style multilevel bisection of the induced subgraph
    (heavy-edge matching + FM refinement + weighted vertex cover); None
    when the native library is unavailable."""
    from .native_symbolic import multilevel_bisect_native

    nodes = sorted(nodes)
    pos = {v: i for i, v in enumerate(nodes)}
    sub_adj = [
        {pos[w] for w in adj[v] if w in pos} for v in nodes
    ]
    sub_w = [max(1, weights[v]) for v in nodes]
    side = multilevel_bisect_native(sub_adj, sub_w)
    if side is None:
        return None
    left = [nodes[i] for i in range(len(nodes)) if side[i] == 0]
    right = [nodes[i] for i in range(len(nodes)) if side[i] == 1]
    sep = [nodes[i] for i in range(len(nodes)) if side[i] == 2]
    return sorted(left), sorted(right), sorted(sep)


def _bisect(adj, nodes, weights, multilevel=False, memo=None):
    """Split nodes into (left, right, separator): race the spectral
    (Fiedler) ordering against the BFS level-set ordering — and, when
    `multilevel` is set, the native METIS-style multilevel bisection —
    keeping the best (separator weight × balance²) candidate.  No single
    strategy dominates per cut, and per-cut scores cannot see plan-level
    padding effects, so the ND analysis additionally races WHOLE plans
    with multilevel on/off by flop estimate (analyze_nested_dissection)."""
    # `memo` (a dict shared by the passes of one analysis over one graph)
    # keeps each cut and each spectral order once: the passes race depths
    # and bisector modes, whose cuts repeat, and every one of them is a
    # deterministic function of the node list, so the plans are those
    # computed afresh
    key = (tuple(nodes), multilevel)
    if memo is not None and key in memo:
        return memo[key]
    candidates = []
    if multilevel:
        ml = _multilevel_candidate(adj, nodes, weights)
        if ml is not None:
            candidates.append(ml)
    skey = ("spectral", tuple(sorted(nodes)))
    if memo is not None and skey in memo:
        order = memo[skey]
    else:
        order = _spectral_order(adj, sorted(nodes))
        if memo is not None:
            memo[skey] = order
    if order is not None:
        candidates.append(_split_order(order, adj, weights))
    candidates.append(_split_order(_bfs_order(adj, nodes), adj, weights))
    best = None
    best_w = None
    for cand in candidates:
        left, right, sep = cand
        if not left or not right:
            continue
        w = float(sum(weights[v] for v in sep))
        # balance matters as much as separator size for the downstream
        # level-synchronous plans: every level pads to the HEAVIEST block,
        # so a lopsided split inflates every padded front at that level.
        lw = sum(weights[v] for v in left)
        rw = sum(weights[v] for v in right)
        imb = max(lw, rw) / max(1.0, 0.5 * (lw + rw))  # 1.0 = perfect
        score = w * imb ** 2
        if best is None or score < best_w:
            best, best_w = cand, score
    out = best if best is not None else candidates[-1]
    if memo is not None:
        memo[key] = out
    return out


def analyze_block_arrow(P_mask, A_mask, layout: ConeLayout,
                        target_blocks: int = 8,
                        min_block: int = 8,
                        soc_rank2_min_dim=None) -> Optional[BlockArrowPlan]:
    """Try to find a useful block-arrow structure; None if the separator
    would be too large relative to N.  Races plans built with the native
    multilevel bisector on and off, keeping the cheaper flop estimate."""
    from .native_symbolic import available as _native_available

    best = None
    modes = (False, True) if _native_available() else (False,)
    memo = {}
    for multilevel in modes:
        plan = _analyze_block_arrow_once(P_mask, A_mask, layout,
                                         target_blocks, min_block,
                                         multilevel, soc_rank2_min_dim,
                                         memo)
        if plan is not None and (
            best is None or plan.flop_estimate() < best.flop_estimate()
        ):
            best = plan
    return best


def _analyze_block_arrow_once(P_mask, A_mask, layout: ConeLayout,
                              target_blocks: int, min_block: int,
                              multilevel: bool,
                              soc_rank2_min_dim=None, memo=None
                              ) -> Optional[BlockArrowPlan]:
    """One block-arrow analysis pass with a fixed bisector configuration.

    P_mask/A_mask: dense boolean masks OR ((rows, cols), shape) patterns.
    """
    P_pat = _as_pattern(P_mask)
    A_pat = _as_pattern(A_mask)
    n = P_pat[2][0]
    m = A_pat[2][0]
    N = n + m
    adj, node_rows = _kkt_supernode_graph(P_pat, A_pat, layout,
                                          soc_rank2_min_dim)
    weights = [len(r) for r in node_rows]

    # recursive bisection until we reach the target block count
    parts: List[List[int]] = [list(range(len(adj)))]
    separators: List[int] = []
    while len(parts) < target_blocks:
        parts.sort(key=len, reverse=True)
        big = parts.pop(0)
        if len(big) < 2 * min_block:
            parts.append(big)
            break
        left, right, sep = _bisect(adj, big, weights,
                                   multilevel=multilevel, memo=memo)
        if not left or not right:
            parts.append(big)
            break
        separators.extend(sep)
        parts.append(left)
        parts.append(right)

    if len(parts) < 2:
        return None

    # expand nodes to KKT rows
    def expand(node_list):
        out = []
        for v in node_list:
            out.extend(node_rows[v])
        return sorted(out)

    block_rows = [expand(p) for p in parts]
    tail_rows = expand(sorted(set(separators)))

    nt = len(tail_rows)
    if nt == 0 or nt > N // 3:
        return None  # separator too large: dense/blocked is better

    nb = max(len(b) for b in block_rows)
    # large blocks use the 128-blocked LDL kernel: pad width to a multiple
    if nb >= 192:
        nb = ((nb + 127) // 128) * 128
    p = len(block_rows)

    signs_full = np.concatenate([np.ones(n), -np.ones(m)])
    block_idx = np.full((p, nb), N, dtype=np.int32)
    block_signs = np.ones((p, nb))
    for i, rows in enumerate(block_rows):
        block_idx[i, :len(rows)] = rows
        block_signs[i, :len(rows)] = signs_full[rows]
    tail_idx = np.asarray(tail_rows, dtype=np.int32)
    tail_signs = signs_full[tail_rows]

    perm = np.concatenate([np.concatenate(
        [np.asarray(b, dtype=np.int64) for b in block_rows]
    ), tail_idx.astype(np.int64)])

    return BlockArrowPlan(
        perm=perm, block_idx=block_idx, tail_idx=tail_idx,
        block_signs=block_signs, tail_signs=tail_signs, n=n, m=m,
    )
