"""Chordal decomposition of sparse PSD cones.

Host-side setup transform (reference: src/chordal/): detects aggregate
sparsity in PSD-cone rows of [A b], computes a chordal extension +
supernodal clique tree per cone, merges cliques, and rewrites the problem
with clique-sized PSD cones plus overlap equalities.  Two transforms:

* compact (default) — per-clique row remapping with +1/−1 overlap columns
  (reference: decomposition/augment_compact.jl; Kim et al. 2011 p.53)
* standard — A_new = [A H; 0 −I] with an equality cone
  (reference: decomposition/augment_standard.jl)

Reversal scatters per-clique blocks back and optionally performs the
Vandenberghe PSD completion of the dual variable
(reference: decomposition/psd_completion.jl).

The transform runs on dense numpy arrays: the solver's dense path holds
dense data, and the clique blocks it emits are small PSD cones.  A copy of
`clarabel_tpu/chordal/decomp.py` over the port's cone classes.
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..cones.api import (
    SupportedCone, PSDTriangleConeT, ZeroConeT, nvars, triangular_number,
)
from .symbolic import find_graph
from .sntree import SuperNodeTree
from .merge import merge_cliques


def _tri_index(i: int, j: int) -> int:
    """0-based svec position of entry (i, j), i <= j, column-major triu."""
    return (j * (j + 1)) // 2 + i


@dataclasses.dataclass
class SparsityPattern:
    sntree: SuperNodeTree
    ordering: np.ndarray     # permuted vertex -> original vertex
    orig_index: int          # index of the cone being decomposed


@dataclasses.dataclass
class ConeMapEntry:
    orig_index: int
    tree_and_clique: Optional[Tuple[int, int]]


class ChordalInfo:
    """reference: src/chordal/chordal_info.jl"""

    def __init__(self, A: np.ndarray, b: np.ndarray,
                 cones: List[SupportedCone], settings):
        self.init_dims = (A.shape[1], A.shape[0])   # (n, m)
        self.init_cones = list(cones)
        self.spatterns: List[SparsityPattern] = []
        self.H: Optional[np.ndarray] = None
        self.cone_maps: Optional[List[ConeMapEntry]] = None

        merge_method = settings.chordal_decomposition_merge_method

        # aggregate sparsity: rows of [A b] with any nonzero
        nz_mask_full = (np.abs(A).sum(axis=1) != 0) | (b != 0)

        ofs = 0
        for coneidx, cone in enumerate(cones):
            k = nvars(cone)
            if isinstance(cone, PSDTriangleConeT):
                mask = nz_mask_full[ofs:ofs + k].copy()
                # force diagonal marks (reference: chordal_info.jl:100-104)
                for i in range(cone.dim):
                    mask[_tri_index(i, i)] = True
                if not mask.all():
                    Lcols, ordering = find_graph(mask, cone.dim)
                    sntree = SuperNodeTree(Lcols)
                    merge_cliques(merge_method, sntree)
                    ordering = sntree.reorder_snode_consecutively(ordering)
                    sntree.calculate_block_dimensions()
                    if sntree.n_cliques > 1:
                        self.spatterns.append(
                            SparsityPattern(sntree, ordering, coneidx)
                        )
            ofs += k

    @property
    def is_decomposed(self) -> bool:
        return len(self.spatterns) > 0

    def _cone_ranges(self):
        out = []
        ofs = 0
        for c in self.init_cones:
            k = nvars(c)
            out.append((ofs, ofs + k))
            ofs += k
        return out

    def get_decomposed_dim_and_overlaps(self):
        """reference: chordal_info.jl:178-199"""
        pat_by_cone = {p.orig_index: p for p in self.spatterns}
        sum_cols = 0
        sum_overlaps = 0
        for coneidx, cone in enumerate(self.init_cones):
            if coneidx in pat_by_cone:
                c, o = pat_by_cone[coneidx].sntree.get_decomposed_dim_and_overlaps()
            else:
                c, o = nvars(cone), 0
            sum_cols += c
            sum_overlaps += o
        return sum_cols, sum_overlaps


def try_chordal_decomposition(P, q, A, b, cones, settings):
    """Returns (chordal_info, P', q', A', b', cones') or None."""
    if not settings.chordal_decomposition_enable:
        return None
    if not any(isinstance(c, PSDTriangleConeT) and c.dim > 2 for c in cones):
        return None
    info = ChordalInfo(A, b, cones, settings)
    if not info.is_decomposed:
        return None
    if settings.chordal_decomposition_compact:
        Pn, qn, An, bn, cn = _augment_compact(info, P, q, A, b)
    else:
        Pn, qn, An, bn, cn = _augment_standard(info, P, q, A, b)
    return info, Pn, qn, An, bn, cn


# ---------------------------------------------------------------------------
# compact augmentation (reference: decomposition/augment_compact.jl)
# ---------------------------------------------------------------------------

def _augment_compact(info: ChordalInfo, P, q, A, b):
    n = A.shape[1]
    rows_new, n_overlaps = info.get_decomposed_dim_and_overlaps()

    A_new = np.zeros((rows_new, n + n_overlaps))
    b_new = np.zeros(rows_new)
    cones_new: List[SupportedCone] = []
    cone_maps: List[ConeMapEntry] = []

    pat_by_cone = {p.orig_index: (k, p) for k, p in enumerate(info.spatterns)}
    ranges = info._cone_ranges()

    row_ptr = 0
    overlap_col = n
    for coneidx, cone in enumerate(info.init_cones):
        lo, hi = ranges[coneidx]
        if coneidx in pat_by_cone:
            pattern_idx, pattern = pat_by_cone[coneidx]
            row_ptr, overlap_col = _add_entries_with_pattern(
                A_new, b_new, cones_new, cone_maps, A, b, lo,
                pattern, pattern_idx, row_ptr, overlap_col,
            )
        else:
            k = hi - lo
            A_new[row_ptr:row_ptr + k, :n] = A[lo:hi, :]
            b_new[row_ptr:row_ptr + k] = b[lo:hi]
            cones_new.append(cone)
            cone_maps.append(ConeMapEntry(coneidx, None))
            row_ptr += k

    info.cone_maps = cone_maps

    nadd = n_overlaps
    P_new = np.zeros((n + nadd, n + nadd))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.zeros(nadd)])
    return P_new, q_new, A_new, b_new, cones_new


def _get_block_indices(snode, separator, nv):
    """(i, j, is_overlap) entries of the clique block, svec-sorted.
    reference: augment_compact.jl get_block_indices"""
    out = []
    for j in separator:
        for i in separator:
            if i <= j:
                out.append((i, j, True))
    for j in snode:
        for i in snode:
            if i <= j:
                out.append((i, j, False))
    for i in snode:
        for j in separator:
            out.append((min(i, j), max(i, j), False))
    out.sort(key=lambda x: x[1] * nv + x[0])
    return out


def _add_entries_with_pattern(A_new, b_new, cones_new, cone_maps, A, b,
                              range_start, pattern: SparsityPattern,
                              pattern_idx, row_ptr, overlap_col):
    sntree = pattern.sntree
    ordering = pattern.ordering
    nv = len(ordering)

    # row ranges per clique, laid out in reverse postorder (root first)
    # (reference: augment_compact.jl clique_rows_map)
    clique_rows = {}
    rp = row_ptr
    for i in range(sntree.n_cliques - 1, -1, -1):
        num = triangular_number(sntree.get_nblk(i))
        clique_rows[int(sntree.snode_post[i])] = rp
        rp += num

    for i in range(sntree.n_cliques - 1, -1, -1):
        separator = sorted(int(ordering[v]) for v in sntree.get_separators(i))
        snode = sorted(int(ordering[v]) for v in sntree.get_snode(i))
        block_indices = _get_block_indices(snode, separator, nv)

        if i == sntree.n_cliques - 1:
            parent_rows = None
            parent_clique = []
        else:
            parent_index = int(sntree.get_clique_parent(i))
            parent_rows = clique_rows[parent_index]
            parent_clique = sorted(
                int(ordering[v]) for v in sntree.get_clique_by_index(parent_index)
            )

        for counter, (vi, vj, is_overlap) in enumerate(block_indices):
            new_row = row_ptr + counter
            if is_overlap:
                A_new[new_row, overlap_col] = 1.0
                # locate the entry in the parent clique block
                ir = parent_clique.index(vi)
                jr = parent_clique.index(vj)
                parent_row = parent_rows + _tri_index(ir, jr)
                A_new[parent_row, overlap_col] = -1.0
                overlap_col += 1
            else:
                orig_row = range_start + _tri_index(vi, vj)
                A_new[new_row, :A.shape[1]] = A[orig_row, :]
                b_new[new_row] = b[orig_row]

        cone_dim = int(sntree.get_nblk(i))
        cones_new.append(PSDTriangleConeT(cone_dim))
        cone_maps.append(ConeMapEntry(pattern.orig_index, (pattern_idx, i)))
        row_ptr += triangular_number(cone_dim)

    return row_ptr, overlap_col


# ---------------------------------------------------------------------------
# standard augmentation (reference: decomposition/augment_standard.jl)
# ---------------------------------------------------------------------------

def _augment_standard(info: ChordalInfo, P, q, A, b):
    n = A.shape[1]
    m = A.shape[0]
    lenH, _ = info.get_decomposed_dim_and_overlaps()

    H = np.zeros((m, lenH))
    cones_new: List[SupportedCone] = [ZeroConeT(m)]
    pat_by_cone = {p.orig_index: p for p in info.spatterns}
    ranges = info._cone_ranges()

    col = 0
    for coneidx, cone in enumerate(info.init_cones):
        lo, hi = ranges[coneidx]
        if coneidx in pat_by_cone:
            pattern = pat_by_cone[coneidx]
            sntree = pattern.sntree
            for i in range(sntree.n_cliques):
                cl = sorted(int(pattern.ordering[v]) for v in sntree.get_clique(i))
                for j in range(len(cl)):
                    for ii in range(j + 1):
                        row = lo + _tri_index(cl[ii], cl[j])
                        H[row, col] = 1.0
                        col += 1
                cones_new.append(PSDTriangleConeT(int(sntree.get_nblk(i))))
        else:
            k = hi - lo
            H[lo:hi, col:col + k] = np.eye(k)
            col += k
            cones_new.append(cone)

    info.H = H

    P_new = np.zeros((n + lenH, n + lenH))
    P_new[:n, :n] = P
    q_new = np.concatenate([q, np.zeros(lenH)])
    A_new = np.block([
        [A, H],
        [np.zeros((lenH, n)), -np.eye(lenH)],
    ])
    b_new = np.concatenate([b, np.zeros(lenH)])
    return P_new, q_new, A_new, b_new, cones_new


# ---------------------------------------------------------------------------
# reversal (reference: decomposition/decomp.jl, reverse_*.jl)
# ---------------------------------------------------------------------------

def decomp_reverse(info: ChordalInfo, x, z, s, old_cones, settings):
    """Map decomposed-problem variables back to the original problem."""
    n, m = info.init_dims
    new_x = x[:n].copy()
    new_s = np.zeros(m)
    new_z = np.zeros(m)

    if info.cone_maps is not None:
        _reverse_compact(info, new_s, new_z, s, z, old_cones)
    else:
        _reverse_standard(info, new_s, new_z, s, z)

    if settings.chordal_decomposition_complete_dual:
        _psd_completion(info, new_z)

    return new_x, new_z, new_s


def _reverse_compact(info, new_s, new_z, old_s, old_z, old_cones):
    """reference: decomposition/reverse_compact.jl"""
    ranges = info._cone_ranges()
    row_ptr = 0
    for cone, cmap in zip(old_cones, info.cone_maps):
        lo, hi = ranges[cmap.orig_index]
        if cmap.tree_and_clique is None:
            k = nvars(cone)
            new_s[lo:hi] = old_s[row_ptr:row_ptr + k]
            new_z[lo:hi] = old_z[row_ptr:row_ptr + k]
            row_ptr += k
        else:
            tree_index, clique_index = cmap.tree_and_clique
            pattern = info.spatterns[tree_index]
            clique = sorted(
                int(pattern.ordering[v])
                for v in pattern.sntree.get_clique(clique_index)
            )
            counter = 0
            for j in clique:
                for i in clique:
                    if i <= j:
                        offset = _tri_index(i, j)
                        new_s[lo + offset] += old_s[row_ptr + counter]
                        # z overwrites on overlaps
                        new_z[lo + offset] = old_z[row_ptr + counter]
                        counter += 1
            row_ptr += triangular_number(len(clique))


def _reverse_standard(info, new_s, new_z, old_s, old_z):
    """reference: decomposition/reverse_standard.jl"""
    H = info.H
    m = H.shape[0]
    s_dec = old_s[m:]
    z_dec = old_z[m:]
    new_s[:] = H @ s_dec
    new_z[:] = H @ z_dec
    counts = H.sum(axis=1)
    overlap = counts > 1
    new_z[overlap] /= counts[overlap]


# ---------------------------------------------------------------------------
# PSD completion (reference: decomposition/psd_completion.jl, Vandenberghe)
# ---------------------------------------------------------------------------

def _svec_to_mat_np(x, nd):
    M = np.zeros((nd, nd))
    isqrt2 = 1.0 / np.sqrt(2.0)
    idx = 0
    for col in range(nd):
        for row in range(col + 1):
            if row == col:
                M[row, col] = x[idx]
            else:
                M[row, col] = x[idx] * isqrt2
                M[col, row] = x[idx] * isqrt2
            idx += 1
    return M


def _mat_to_svec_np(M):
    nd = M.shape[0]
    isqrt2 = 1.0 / np.sqrt(2.0)
    out = np.zeros(triangular_number(nd))
    idx = 0
    for col in range(nd):
        for row in range(col + 1):
            if row == col:
                out[idx] = M[row, col]
            else:
                out[idx] = (M[row, col] + M[col, row]) * isqrt2
            idx += 1
    return out


def _psd_completion(info: ChordalInfo, z):
    ranges = info._cone_ranges()
    for pattern in info.spatterns:
        lo, hi = ranges[pattern.orig_index]
        nd = len(pattern.ordering)
        Z = _svec_to_mat_np(z[lo:hi], nd)
        _psd_complete(Z, pattern)
        z[lo:hi] = _mat_to_svec_np(Z)


def _psd_complete(Amat, pattern: SparsityPattern):
    """Vandenberghe completion sweep (reference: psd_completion.jl:44-105)."""
    sntree = pattern.sntree
    p = pattern.ordering
    N = Amat.shape[0]
    ip = np.empty(N, dtype=np.int64)
    ip[p] = np.arange(N)

    W = Amat[np.ix_(p, p)]

    for j in range(sntree.n_cliques - 2, -1, -1):
        nu = list(sntree.get_snode(j))
        alpha = list(sntree.get_separators(j))
        if not nu:
            continue
        i0 = nu[0]
        excl = set(alpha) | set(nu)
        eta = [k for k in range(i0 + 1, N) if k not in excl]
        if not alpha or not eta:
            continue

        Waa = W[np.ix_(alpha, alpha)]
        Wan = W[np.ix_(alpha, nu)]
        Wea = W[np.ix_(eta, alpha)]
        try:
            Y = np.linalg.solve(Waa, Wan)
        except np.linalg.LinAlgError:
            Y = np.linalg.pinv(Waa) @ Wan

        W[np.ix_(eta, nu)] = Wea @ Y
        W[np.ix_(nu, eta)] = W[np.ix_(eta, nu)].T

    Amat[:, :] = W[np.ix_(ip, ip)]
