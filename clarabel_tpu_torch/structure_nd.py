"""Host-side multilevel nested-dissection symbolic analysis.

A copy of `clarabel_tpu/structure_nd.py` (numpy only).  It generalizes the
single-level block-arrow plan (structure.py) to a perfect binary
dissection tree: the KKT quotient graph is bisected recursively, each
internal tree node owns its separator rows, each leaf owns a block of
interior rows.  Factorization becomes a level-synchronous multifrontal
LDLᵀ (`kkt/multifrontal.py`): at every tree level all frontal matrices
have the same padded shape and are factored as one batch, so the sparse
factorization is one batched dense factorization per level.  The symbolic
phase runs once on the host; the per-iteration numeric factorization has
static shapes (reference: src/kktsolvers/direct-ldl/directldl_qdldl.jl:
17-25, symbolic once, numeric refactor per iteration).

Terminology (level 0 = root, level L = leaves):
  rows(t)  — KKT rows owned by tree node t (separator rows, or a leaf block)
  bnd(t)   — "boundary": ancestor-owned rows reachable from subtree(t);
             the frontal matrix of t covers rows(t) ++ bnd(t), and
             eliminating rows(t) produces an update matrix over bnd(t)
             that extend-adds into the parent's front.
"""

import dataclasses
from typing import List, Optional

import numpy as np

from .structure import _as_pattern, _kkt_supernode_graph, _bisect


@dataclasses.dataclass
class NestedLevel:
    """Static per-level index maps (all indices into the ORIGINAL KKT,
    sentinel >= N at pads)."""
    rows_idx: np.ndarray    # (cnt, nr)  rows owned by each node
    bnd_idx: np.ndarray     # (cnt, nbd) boundary rows of each node
    rows_signs: np.ndarray  # (cnt, nr)  quasidefinite pivot signs (pads +1)
    # position of each bnd element inside the PARENT's front vector
    # (rows(parent) ++ bnd(parent)); sentinel = parent front size at pads.
    # Empty (cnt, 0) at the root level.
    up_pos: np.ndarray      # (cnt, nbd)

    @property
    def cnt(self) -> int:
        return self.rows_idx.shape[0]

    @property
    def nr(self) -> int:
        return self.rows_idx.shape[1]

    @property
    def nbd(self) -> int:
        return self.bnd_idx.shape[1]

    @property
    def f(self) -> int:
        return self.nr + self.nbd


@dataclasses.dataclass
class NestedPlan:
    """Multilevel dissection plan: levels[0] is the root (1 node, empty
    boundary), levels[-1] are the leaves."""
    levels: List[NestedLevel]
    n: int
    m: int

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def key(self):
        import hashlib

        h = hashlib.sha1()
        for lv in self.levels:
            for a in (lv.rows_idx, lv.bnd_idx, lv.rows_signs, lv.up_pos):
                h.update(np.ascontiguousarray(a).tobytes())
        shapes = tuple((lv.cnt, lv.nr, lv.nbd) for lv in self.levels)
        return (self.n, self.m, shapes, h.hexdigest())

    def flop_estimate(self) -> float:
        """Rough factorization flop count (for backend auto-selection)."""
        total = 0.0
        for lv in self.levels:
            nr, nbd, cnt = lv.nr, lv.nbd, lv.cnt
            total += cnt * (nr ** 3 / 3 + nr ** 2 * nbd + nr * nbd ** 2)
        return total


def _pad_width(k: int) -> int:
    """Pad a block width: small blocks to a multiple of 8, large blocks to
    a multiple of 128 (the blocked-LDL kernel regime)."""
    if k == 0:
        return 0
    if k >= 192:
        return ((k + 127) // 128) * 128
    return ((k + 7) // 8) * 8


def analyze_nested_dissection(P_mask, A_mask, layout,
                              depth: Optional[int] = None,
                              min_block: int = 16,
                              max_bnd_frac: float = 0.75,
                              ) -> Optional[NestedPlan]:
    """Build a NestedPlan by recursive bisection of the KKT quotient
    graph; races whole plans built with the native multilevel (METIS
    style) bisector on and off and keeps the cheaper flop estimate —
    per-cut quality does not predict plan cost (level-synchronous fronts
    pad to the heaviest block per level).  Returns None when no useful
    structure exists."""
    from .native_symbolic import available as _native_available

    # race bisector modes AND tree depths.  The old fixed ~384-row-leaf
    # depth heuristic left large fill on the table: on a 30x30 grid KKT
    # it picked depth 3 (4.3x the minimum-degree fill, 7.5e7 padded
    # front flops) where depth 6 reaches 0.93x MMD fill and 6.4e6 flops
    # (benchmarks/ordering_quality.py; docs/ORDERING.md).  Each plan is
    # scored by padded-front flops plus a small per-level charge for the
    # extra level-synchronous stages deeper trees execute.
    LEVEL_COST_FLOPS = 2.0e5

    def score(p: NestedPlan) -> float:
        return p.flop_estimate() + LEVEL_COST_FLOPS * len(p.levels)

    best = None
    modes = (False, True) if _native_available() else (False,)
    if depth is not None:
        depths = (depth,)
    else:
        depths = (None, "auto+1", "auto+2", "auto+3")
        # near-1D patterns (chains/bands) keep gaining from depth well
        # past the grid sweet spot and the symbolic cost stays small
        depths += ("auto+4", "auto+5")
    memo = {}   # the cuts the passes share (structure._bisect)
    for multilevel in modes:
        for d in depths:
            plan = _analyze_nd_once(P_mask, A_mask, layout, d, min_block,
                                    max_bnd_frac, multilevel, memo)
            if plan is not None and (
                best is None or score(plan) < score(best)
            ):
                best = plan
    return best


def _analyze_nd_once(P_mask, A_mask, layout, depth, min_block,
                     max_bnd_frac, multilevel, memo=None
                     ) -> Optional[NestedPlan]:
    """One ND analysis pass with a fixed bisector configuration.

    P_mask/A_mask: dense boolean masks OR ((rows, cols), shape) patterns.
    """
    P_pat = _as_pattern(P_mask)
    A_pat = _as_pattern(A_mask)
    n = P_pat[2][0]
    m = A_pat[2][0]
    N = n + m
    adj, node_rows = _kkt_supernode_graph(P_pat, A_pat, layout)
    weights = [len(r) for r in node_rows]
    nq = len(adj)

    if depth is None or isinstance(depth, str):
        # base heuristic: leaves of ~256-512 KKT rows, at least 2
        # levels to be "nested"; "auto+k" deepens by k (the caller
        # races depths by flop estimate — deeper trees trade batched
        # front size for much lower fill, benchmarks/ordering_quality)
        target_leaf_rows = 384
        extra = int(depth[5:]) if isinstance(depth, str) else 0
        depth = int(np.ceil(np.log2(max(2.0, N / target_leaf_rows))))
        depth = int(np.clip(depth + extra, 2, 10))

    # ---- recursive bisection into a perfect binary tree -----------------
    # tree arrays indexed by heap order: node 0 = root, children 2t+1/2t+2
    n_tree = 2 ** (depth + 1) - 1
    own_q: List[List[int]] = [[] for _ in range(n_tree)]

    def rec(nodes: List[int], t: int, level: int):
        if level == depth:
            own_q[t] = list(nodes)
            return
        if len(nodes) < 2 * min_block:
            # too small to split: everything goes to the left subtree's
            # leaves; the separator and right subtree stay empty
            own_q[t] = []
            rec(nodes, 2 * t + 1, level + 1)
            rec([], 2 * t + 2, level + 1)
            return
        left, right, sep = _bisect(adj, sorted(nodes), weights,
                                   multilevel=multilevel, memo=memo)
        if not left or not right:
            own_q[t] = []
            rec(sorted(nodes), 2 * t + 1, level + 1)
            rec([], 2 * t + 2, level + 1)
            return
        own_q[t] = list(sep)
        rec(left, 2 * t + 1, level + 1)
        rec(right, 2 * t + 2, level + 1)

    rec(list(range(nq)), 0, 0)

    # quotient node -> owning tree node
    q_owner = np.full(nq, -1, dtype=np.int64)
    for t, qs in enumerate(own_q):
        for v in qs:
            q_owner[v] = t
    assert not np.any(q_owner < 0)

    def ancestors(t: int) -> List[int]:
        out = []
        while t > 0:
            t = (t - 1) // 2
            out.append(t)
        return out  # parent, grandparent, ..., root

    def level_of(t: int) -> int:
        return int(np.floor(np.log2(t + 1)))

    # ---- boundary sets (quotient granularity), bottom-up ----------------
    bnd_q: List[set] = [set() for _ in range(n_tree)]
    for t in range(n_tree - 1, -1, -1):
        anc = set(ancestors(t))
        reach = set()
        if 2 * t + 1 < n_tree:
            reach |= bnd_q[2 * t + 1] | bnd_q[2 * t + 2]
        for v in own_q[t]:
            reach |= adj[v]
        bnd_q[t] = {w for w in reach if q_owner[w] in anc}

    # ---- expand to KKT rows with a consistent front ordering ------------
    # rows(t): KKT rows of own quotient nodes, ascending.
    rows_of: List[np.ndarray] = []
    for t in range(n_tree):
        rr = []
        for v in sorted(own_q[t]):
            rr.extend(node_rows[v])
        rows_of.append(np.asarray(sorted(rr), dtype=np.int64))

    # front ordering is defined top-down: front(t) = rows(t) ++ bnd(t),
    # bnd(t) ordered by position inside the parent's front.
    front_pos: List[dict] = [dict() for _ in range(n_tree)]  # row -> pos
    bnd_rows: List[np.ndarray] = [None] * n_tree
    bnd_rows[0] = np.zeros((0,), dtype=np.int64)
    for t in range(n_tree):
        if t > 0:
            par = (t - 1) // 2
            brows = []
            for v in bnd_q[t]:
                brows.extend(node_rows[v])
            brows.sort(key=lambda r: front_pos[par][r])
            bnd_rows[t] = np.asarray(brows, dtype=np.int64)
        pos = {}
        for i, r in enumerate(rows_of[t]):
            pos[int(r)] = i
        base = len(rows_of[t])
        for i, r in enumerate(bnd_rows[t]):
            pos[int(r)] = base + i
        front_pos[t] = pos

    # ---- per-level padded plans -----------------------------------------
    # positions must be computed against the PADDED parent front layout
    # (rows pad to nr, boundary starts at nr), so padded position maps are
    # built level-by-level top-down.
    signs_full = np.concatenate([np.ones(n), -np.ones(m)])
    levels: List[NestedLevel] = []
    padded_pos: List[dict] = [dict() for _ in range(n_tree)]  # row -> pos
    lo = 0
    for lv in range(depth + 1):
        cnt = 2 ** lv
        ts = list(range(lo, lo + cnt))
        lo += cnt
        nr = _pad_width(max((len(rows_of[t]) for t in ts), default=0))
        nr = max(nr, 1)  # keep at least one pivot so shapes stay nonzero
        nbd = _pad_width(max((len(bnd_rows[t]) for t in ts), default=0))

        rows_idx = np.full((cnt, nr), N, dtype=np.int32)
        rows_signs = np.ones((cnt, nr))
        bnd_idx = np.full((cnt, nbd), N, dtype=np.int32)
        up_pos = np.zeros((cnt, nbd), dtype=np.int32)
        if lv > 0:
            par_lv = levels[lv - 1]
            up_pos[:] = par_lv.f  # sentinel
        for i, t in enumerate(ts):
            rr = rows_of[t]
            rows_idx[i, :len(rr)] = rr
            rows_signs[i, :len(rr)] = signs_full[rr]
            br = bnd_rows[t]
            bnd_idx[i, :len(br)] = br
            for j, r in enumerate(rr):
                padded_pos[t][int(r)] = j
            for j, r in enumerate(br):
                padded_pos[t][int(r)] = nr + j
            if lv > 0:
                par = (t - 1) // 2
                for j, r in enumerate(br):
                    up_pos[i, j] = padded_pos[par][int(r)]
        levels.append(NestedLevel(rows_idx=rows_idx, bnd_idx=bnd_idx,
                                  rows_signs=rows_signs, up_pos=up_pos))

    plan = NestedPlan(levels=levels, n=n, m=m)

    # usefulness checks: boundaries must stay small relative to fronts and
    # the flop estimate must beat the dense factorization by a margin
    for lv in plan.levels[1:]:
        if lv.nbd > max_bnd_frac * N:
            return None
    dense_flops = N ** 3 / 3
    if plan.flop_estimate() > 0.5 * dense_flops:
        return None
    return plan


def node_of_rows(plan: NestedPlan):
    """(tree-node id, position-in-front) for every KKT row — used by the
    sparse assembly map builder."""
    N = plan.n + plan.m
    owner = np.full(N, -1, dtype=np.int64)
    pos = np.full(N, -1, dtype=np.int64)
    t = 0
    for lv in plan.levels:
        for i in range(lv.cnt):
            rr = lv.rows_idx[i]
            real = rr[rr < N]
            owner[real] = t
            pos[real] = np.arange(len(real))
            t += 1
    assert not np.any(owner < 0)
    return owner, pos
