"""Map-based multifrontal KKT assembly for sparse problem data, batched over
a leading lane axis.

A port of `clarabel_tpu/kkt/assembly_maps_nd.py`, the multilevel analogue
of assembly_maps.py (the counterpart of the reference's one-pass CSC
assembly with per-source index maps, reference:
src/kktsolvers/direct-ldl/directldl_kkt_assembly.jl): at setup the host
computes, for every structural nonzero of the KKT matrix, its destination
inside the packed per-level frontal buffers of a NestedPlan.  Per
iteration the device sums the concatenated source values [P_vals; A_vals;
A_vals; −Hs_vals] into the level fronts, in a fixed order
(`linalg.matops.SegmentSum`), and runs the level-synchronous multifrontal
factorization: no dense K, no dense Hs, so the problem size is bounded by
the pattern, not N².
"""

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..cones import ops as cone_ops
from ..cones.layout import ConeLayout
from ..linalg.matops import SegmentSum, on_device
from ..settings import torch_dtype
from ..structure_nd import NestedPlan


@dataclasses.dataclass
class NestedAssemblyMaps:
    dest: np.ndarray            # (n_src,) flat index into the level buffer
    pad_diag_dest: np.ndarray   # unit pivots at padded row positions
    diag_dest: np.ndarray       # (N,) destination of each true KKT diagonal
    diag_signs: np.ndarray      # (N,) ±1 in KKT row order
    level_offsets: Tuple[int, ...]   # flat offset of each level's fronts
    n_P: int
    n_A: int
    n_hs: int
    plan: NestedPlan

    def summer(self) -> SegmentSum:
        """The fixed-order sum of the sources into the buffer, made once."""
        s = self.__dict__.get("_summer")
        if s is None:
            s = SegmentSum(self.dest, self.buf_size)
            self._summer = s
        return s

    @property
    def buf_size(self) -> int:
        last = self.plan.levels[-1]
        return self.level_offsets[-1] + last.cnt * last.f * last.f

    @property
    def key(self):
        import hashlib

        h = hashlib.sha1()
        for a in (self.dest, self.diag_dest, self.diag_signs):
            h.update(np.ascontiguousarray(a).tobytes())
        return (self.n_P, self.n_A, self.n_hs, h.hexdigest(),
                self.plan.key)


def build_nested_assembly_maps(P_pattern, A_pattern, layout: ConeLayout,
                               plan: NestedPlan) -> NestedAssemblyMaps:
    """P_pattern/A_pattern: (rows, cols) of structural nonzeros; P must be
    the FULL symmetric pattern."""
    n, m = plan.n, plan.m
    N = n + m
    nlev = len(plan.levels)

    level_offsets = []
    off = 0
    for lv in plan.levels:
        level_offsets.append(off)
        off += lv.cnt * lv.f * lv.f
    buf_size = off
    DROP = buf_size

    # global front-position lookup: key = tree_node * (N+1) + row -> pos
    keys: List[np.ndarray] = []
    poss: List[np.ndarray] = []
    owner = np.full(N, -1, dtype=np.int64)
    t0 = 0
    for lv in plan.levels:
        for i in range(lv.cnt):
            t = t0 + i
            rr = lv.rows_idx[i].astype(np.int64)
            real = rr[rr < N]
            owner[real] = t
            keys.append(t * (N + 1) + real)
            poss.append(np.flatnonzero(rr < N))
            bb = lv.bnd_idx[i].astype(np.int64)
            breal_mask = bb < N
            keys.append(t * (N + 1) + bb[breal_mask])
            poss.append(lv.nr + np.flatnonzero(breal_mask))
        t0 += lv.cnt
    key_arr = np.concatenate(keys)
    pos_arr = np.concatenate(poss).astype(np.int64)
    order = np.argsort(key_arr)
    key_sorted = key_arr[order]
    pos_sorted = pos_arr[order]
    assert not np.any(owner < 0)

    tree_level = np.zeros(t0, dtype=np.int64)
    lo = 0
    for li, lv in enumerate(plan.levels):
        tree_level[lo:lo + lv.cnt] = li
        lo += lv.cnt
    level_first = np.asarray(
        [2 ** li - 1 for li in range(nlev)], dtype=np.int64
    )
    f_of_level = np.asarray([lv.f for lv in plan.levels], dtype=np.int64)
    off_of_level = np.asarray(level_offsets, dtype=np.int64)

    def lookup(key):
        idx = np.searchsorted(key_sorted, key)
        idx_c = np.minimum(idx, len(key_sorted) - 1)
        found = key_sorted[idx_c] == key
        return found, pos_sorted[idx_c]

    def dest_of(r, c):
        r = np.asarray(r, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        oob = (r >= N) | (c >= N)
        rs = np.where(oob, 0, r)
        cs = np.where(oob, 0, c)
        tr, tc = owner[rs], owner[cs]
        # destination node: the deeper of the two owners
        deeper_r = tree_level[tr] >= tree_level[tc]
        t = np.where(deeper_r, tr, tc)
        fr, pi = lookup(t * (N + 1) + rs)
        fc, pj = lookup(t * (N + 1) + cs)
        bad = ~(fr & fc) & ~oob
        if np.any(bad):
            raise ValueError(
                "KKT entry couples non-ancestor tree nodes: "
                "nested partition invalid"
            )
        li = tree_level[t]
        nil = t - level_first[li]
        f = f_of_level[li]
        out = off_of_level[li] + nil * f * f + pi * f + pj
        return np.where(oob, DROP, out)

    Pr, Pc = P_pattern
    Ar, Ac = A_pattern
    hr, hc = cone_ops.hs_coords(layout, n)

    dest = np.concatenate([
        dest_of(Pr, Pc),                              # P block
        dest_of(np.asarray(Ar) + n, Ac),              # A lower-left
        dest_of(np.asarray(Ac), np.asarray(Ar) + n),  # Aᵀ upper-right
        dest_of(hr, hc),                              # −Hs
    ])

    # unit pivots at padded row-diagonal positions
    pad_diag = []
    lo = 0
    for li, lv in enumerate(plan.levels):
        f = lv.f
        for i in range(lv.cnt):
            rr = lv.rows_idx[i]
            for j in range(lv.nr):
                if rr[j] >= N:
                    pad_diag.append(level_offsets[li] + i * f * f
                                    + j * f + j)
        lo += lv.cnt
    pad_diag_dest = np.asarray(pad_diag, dtype=np.int64)

    diag_dest = dest_of(np.arange(N), np.arange(N))
    assert not np.any(diag_dest == DROP)
    diag_signs = np.concatenate([np.ones(n), -np.ones(m)])

    return NestedAssemblyMaps(
        dest=dest, pad_diag_dest=pad_diag_dest, diag_dest=diag_dest,
        diag_signs=diag_signs, level_offsets=tuple(level_offsets),
        n_P=len(Pr), n_A=len(Ar), n_hs=len(hr), plan=plan,
    )


def assemble_fronts(maps: NestedAssemblyMaps, P_vals, A_vals, hs_vals,
                    settings, factor_dtype):
    """Device side: the sources (B, ·) summed into the per-level fronts
    (B, cnt, f, f), with the static regularization on the true diagonal."""
    plan = maps.plan
    dtype = torch_dtype(factor_dtype)
    B = P_vals.shape[0]

    src = torch.cat([P_vals, A_vals, A_vals, -hs_vals], dim=1).to(dtype)
    buf = maps.summer()(src)
    dev = buf.device
    if len(maps.pad_diag_dest):
        # index_fill_: a scalar assigned through an index would be copied
        # from the host, which a CUDA graph cannot capture
        buf.index_fill_(1, on_device(maps, "pad_diag_dest", dev), 1.0)

    if settings.static_regularization_enable:
        dd = on_device(maps, "diag_dest", dev)
        maxdiag = buf[:, dd].abs().amax(dim=1)
        eps = (settings.static_regularization_constant
               + settings.static_regularization_proportional * maxdiag)
        buf[:, dd] += (on_device(maps, "diag_signs", dev).to(dtype)
                       * eps[:, None])

    fronts = []
    for li, lv in enumerate(plan.levels):
        o = maps.level_offsets[li]
        fronts.append(buf[:, o:o + lv.cnt * lv.f * lv.f].reshape(
            B, lv.cnt, lv.f, lv.f))
    return fronts


def factor_from_nested_maps(maps: NestedAssemblyMaps, P_vals, A_vals,
                            hs_vals, settings, factor_dtype):
    """Assemble and factor (the factor is kkt.multifrontal's)."""
    from .multifrontal import factor_from_level_blocks

    fronts = assemble_fronts(maps, P_vals, A_vals, hs_vals, settings,
                             factor_dtype)
    return factor_from_level_blocks(fronts, maps.plan, settings,
                                    factor_dtype)
