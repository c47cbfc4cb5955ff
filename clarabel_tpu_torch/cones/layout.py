"""Static cone layout: the cone list lowered once, at setup time.

A copy of the reference package's `ConeLayout` (numpy and hashlib only):
the per-cone index `ranges`, the barrier `degree`, the structure-of-arrays
`groups` of same-type cones, and the structure `key` that hashes the group
index contents, with the PSD clique-size bucketing of `_psd_buckets`.

The gather/scatter helpers at the end move a group's entries between a
full conic vector and its (count, width) array.  They work on a leading
lane axis: a conic vector is (B, m) or (B, m, k), a group array
(B, count, width) or (B, count, width, k).
"""

import dataclasses
import hashlib
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..linalg.matops import on_device

from .api import (
    SupportedCone,
    ZeroConeT,
    NonnegativeConeT,
    SecondOrderConeT,
    ExponentialConeT,
    PowerConeT,
    GenPowerConeT,
    PSDTriangleConeT,
    nvars,
    cone_degree,
    cone_is_symmetric,
)


@dataclasses.dataclass
class ConeGroup:
    """One batched group of same-type (and same-shape) cones."""

    kind: str  # "zero" | "nn" | "soc" | "psd" | "exp" | "pow" | "genpow"
    # (count, width) indices into the length-m conic vector; (1, k) for
    # the elementwise kinds.  Bucketed SOC groups pad with the sentinel m.
    idx: np.ndarray
    psd_n: int = 0
    alpha: Optional[np.ndarray] = None
    dim1: int = 0
    dim2: int = 0
    # (count,) true cone dims when bucketed/padded; None = width exact
    true_dims: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        return self.idx.shape[0]

    @property
    def width(self) -> int:
        return self.idx.shape[1]


class ConeLayout:
    """Static plan for a Cartesian product of cones, hashable via `.key`."""

    def __init__(self, cones: Sequence[SupportedCone],
                 soc_bucketing: Optional[bool] = None,
                 psd_bucketing: Optional[bool] = None):
        self.cones: Tuple[SupportedCone, ...] = tuple(cones)
        self.m = int(sum(nvars(c) for c in self.cones))
        self.degree = int(sum(cone_degree(c) for c in self.cones))
        self.is_symmetric = all(cone_is_symmetric(c) for c in self.cones)

        self.ranges: List[Tuple[int, int]] = []
        ofs = 0
        for c in self.cones:
            k = nvars(c)
            self.ranges.append((ofs, ofs + k))
            ofs += k

        zero_idx: List[np.ndarray] = []
        nn_idx: List[np.ndarray] = []
        soc_by_dim: Dict[int, List[np.ndarray]] = defaultdict(list)
        psd_by_n: Dict[int, List[np.ndarray]] = defaultdict(list)
        exp_idx: List[np.ndarray] = []
        pow_idx: List[np.ndarray] = []
        pow_alpha: List[float] = []
        genpow_by_shape: Dict[Tuple[int, int], list] = defaultdict(list)

        for cone, (lo, hi) in zip(self.cones, self.ranges):
            rng = np.arange(lo, hi, dtype=np.int32)
            if isinstance(cone, ZeroConeT):
                zero_idx.append(rng)
            elif isinstance(cone, NonnegativeConeT):
                nn_idx.append(rng)
            elif isinstance(cone, SecondOrderConeT):
                soc_by_dim[cone.dim].append(rng)
            elif isinstance(cone, PSDTriangleConeT):
                psd_by_n[cone.dim].append(rng)
            elif isinstance(cone, ExponentialConeT):
                exp_idx.append(rng)
            elif isinstance(cone, PowerConeT):
                pow_idx.append(rng)
                pow_alpha.append(cone.alpha)
            elif isinstance(cone, GenPowerConeT):
                a = np.asarray(cone.alpha, dtype=np.float64)
                genpow_by_shape[(len(cone.alpha), cone.dim2)].append((rng, a))
            else:
                raise TypeError(f"unsupported cone: {cone}")

        self.groups: Dict[str, ConeGroup] = {}
        if zero_idx:
            self.groups["zero"] = ConeGroup("zero", np.concatenate(zero_idx)[None, :])
        if nn_idx:
            self.groups["nn"] = ConeGroup("nn", np.concatenate(nn_idx)[None, :])

        # SOC bucketing: pad many distinct dims to power-of-two buckets
        # (zero-padding an SOC is exact)
        if soc_bucketing is None:
            soc_bucketing = len(soc_by_dim) > 2
        if soc_bucketing and soc_by_dim:
            buckets: Dict[int, List[Tuple[np.ndarray, int]]] = defaultdict(list)
            for dim, rows in soc_by_dim.items():
                bdim = max(4, 1 << (dim - 1).bit_length())
                for r in rows:
                    buckets[bdim].append((r, dim))
            for bdim in sorted(buckets):
                entries = buckets[bdim]
                idx = np.full((len(entries), bdim), self.m, dtype=np.int32)
                tdims = np.zeros(len(entries), dtype=np.int32)
                for i, (r, dim) in enumerate(entries):
                    idx[i, :dim] = r
                    tdims[i] = dim
                exact = bool(np.all(tdims == bdim))
                self.groups[f"soc{bdim}b"] = ConeGroup(
                    "soc", idx, true_dims=None if exact else tdims
                )
        else:
            for dim in sorted(soc_by_dim):
                self.groups[f"soc{dim}"] = ConeGroup(
                    "soc", np.stack(soc_by_dim[dim])
                )
        # PSD clique-size bucketing: many distinct sides pad into a few
        # bucket sides chosen by `_psd_buckets`; a side-k cone is the
        # leading k x k block of the bucket matrix, whose svec positions
        # are a plain prefix (column-major triu), and the pad block is
        # pinned to the identity inside every factorization (cones/psd.py)
        if psd_bucketing is None:
            psd_bucketing = len(psd_by_n) > 4
        if psd_bucketing and psd_by_n:
            for bside, sizes in _psd_buckets(psd_by_n).items():
                entries = [(r, k) for k in sizes for r in psd_by_n[k]]
                tb = bside * (bside + 1) // 2
                idx = np.full((len(entries), tb), self.m, dtype=np.int32)
                tdims = np.zeros(len(entries), dtype=np.int32)
                for i, (r, k) in enumerate(entries):
                    t_k = k * (k + 1) // 2
                    idx[i, :t_k] = r
                    tdims[i] = t_k
                exact = bool(np.all(tdims == tb))
                self.groups[f"psd{bside}b"] = ConeGroup(
                    "psd", idx, psd_n=bside,
                    true_dims=None if exact else tdims)
        else:
            for n in sorted(psd_by_n):
                self.groups[f"psd{n}"] = ConeGroup(
                    "psd", np.stack(psd_by_n[n]), psd_n=n)
        if exp_idx:
            self.groups["exp"] = ConeGroup("exp", np.stack(exp_idx))
        if pow_idx:
            self.groups["pow"] = ConeGroup(
                "pow", np.stack(pow_idx), alpha=np.asarray(pow_alpha, dtype=np.float64)
            )
        for (d1, d2) in sorted(genpow_by_shape):
            entries = genpow_by_shape[(d1, d2)]
            self.groups[f"genpow{d1}_{d2}"] = ConeGroup(
                "genpow",
                np.stack([e[0] for e in entries]),
                alpha=np.stack([e[1] for e in entries]),
                dim1=d1,
                dim2=d2,
            )

        # structure key: hashes the idx CONTENTS, not just shapes (the
        # same cone multiset in another order has the same group shapes
        # but different row maps)
        h = hashlib.sha1()
        for name, g in self.groups.items():
            h.update(name.encode())
            h.update(np.ascontiguousarray(g.idx).tobytes())
            if g.alpha is not None:
                h.update(np.ascontiguousarray(g.alpha).tobytes())
        self.key = (
            tuple(
                (name, g.kind, g.idx.shape, g.psd_n, g.dim1, g.dim2)
                for name, g in self.groups.items()
            ),
            h.hexdigest(),
        )


def _psd_buckets(psd_by_n, max_buckets: int = 4):
    """Partition the distinct PSD sides into <= max_buckets contiguous
    segments (bucket side = segment max) minimizing the total padded
    O(side^3) factorization work, by a 1-D clustering DP.  Returns
    {bucket_side: [sizes in the bucket, ascending]}."""
    sizes = sorted(psd_by_n)
    counts = [len(psd_by_n[k]) for k in sizes]
    D = len(sizes)
    B = min(max_buckets, D)
    # seg[i][j]: cost of sizes[i..j] padded to sizes[j]
    seg = [[float(sizes[j]) ** 3 * sum(counts[i:j + 1]) if j >= i else 0.0
            for j in range(D)] for i in range(D)]
    INF = float("inf")
    # dp[b][j]: least cost of covering sizes[0..j] with b segments
    dp = [[INF] * D for _ in range(B + 1)]
    back = [[-1] * D for _ in range(B + 1)]
    dp[1] = list(seg[0])
    for b in range(2, B + 1):
        for j in range(b - 1, D):
            for i in range(b - 1, j + 1):
                c = dp[b - 1][i - 1] + seg[i][j]
                if c < dp[b][j]:
                    dp[b][j] = c
                    back[b][j] = i
    best_b = min(range(1, B + 1), key=lambda b: dp[b][D - 1])
    bounds = []
    j, b = D - 1, best_b
    while b >= 1:
        i = 0 if b == 1 else back[b][j]
        bounds.append((i, j))
        j, b = i - 1, b - 1
    return {sizes[j]: sizes[i:j + 1] for i, j in reversed(bounds)}


def _on(g: ConeGroup, name: str, arr: np.ndarray, device) -> torch.Tensor:
    """A host index array of group g as a tensor on `device`, made once
    per device (`linalg.matops.on_device`)."""
    return on_device(g, name, device, lambda: arr)


def _contig_start(g: ConeGroup):
    """Start of the group's indices when they are one contiguous range
    (the common case: cones are laid out one after another), else None.
    Contiguous groups use slices instead of gathers."""
    cached = g.__dict__.get("_contig_cache", "unset")
    if cached != "unset":
        return cached
    flat = np.asarray(g.idx).ravel()
    start = int(flat[0]) if flat.size else 0
    padded = g.true_dims is not None and bool(
        np.any(np.asarray(g.true_dims) != g.idx.shape[1]))
    val = (start if flat.size and not padded and np.array_equal(
        flat, np.arange(start, start + flat.size)) else None)
    g._contig_cache = val
    return val


def _gather(vec, g: ConeGroup):
    """(B, m, ...) -> (B, count, width, ...).  Bucketed groups carry the
    out-of-range pad index m, which reads 0 (exact for SOC zero-padding)."""
    B, M = vec.shape[:2]
    start = _contig_start(g)
    if start is not None:
        sl = vec[:, start:start + g.count * g.width]
        return sl.reshape((B, g.count, g.width) + vec.shape[2:])
    idx = _on(g, "idx_fill", np.where(g.idx < M, g.idx, M).astype(np.int64),
              vec.device)
    padded = torch.cat([vec, vec.new_zeros((B, 1) + vec.shape[2:])], dim=1)
    return padded[:, idx]


def _scatter(out, g: ConeGroup, vals):
    """Write (B, count, width, ...) group values into a copy of out
    (B, m, ...); pad entries drop.  Group rows are disjoint, so the
    scatter is an inverse-permutation gather masked to the covered rows."""
    B, M = out.shape[:2]
    flat = vals.reshape((B, g.count * g.width) + vals.shape[3:]).to(out.dtype)
    start = _contig_start(g)
    if start is not None:
        res = out.clone()
        res[:, start:start + g.count * g.width] = flat
        return res
    idx = np.asarray(g.idx).ravel()
    valid = (idx >= 0) & (idx < M)
    pos = np.zeros(M, np.int64)
    cov = np.zeros(M, bool)
    pos[idx[valid]] = np.arange(idx.size)[valid]
    cov[idx[valid]] = True
    pos_t = _on(g, f"scatter_pos{M}", pos, out.device)
    cov_t = _on(g, f"scatter_cov{M}", cov, out.device)
    covb = cov_t.view((1, M) + (1,) * (out.dim() - 2))
    return torch.where(covb, flat[:, pos_t], out)


def _row_range(g: ConeGroup):
    """Contiguous range of a flat (1, k) elementwise group, or None."""
    row = np.asarray(g.idx[0])
    start = int(row[0]) if row.size else 0
    if row.size and np.array_equal(row, np.arange(start, start + row.size)):
        return start, start + row.size
    return None


def _grow(vec, g: ConeGroup):
    """vec[:, g.idx[0]], as a slice when contiguous."""
    rng = _row_range(g)
    if rng is not None:
        return vec[:, rng[0]:rng[1]]
    return vec[:, _on(g, "row", g.idx[0].astype(np.int64), vec.device)]


def _srow_set(out, g: ConeGroup, vals):
    """A copy of out with out[:, g.idx[0]] = vals."""
    res = out.clone()
    rng = _row_range(g)
    if rng is not None:
        res[:, rng[0]:rng[1]] = vals.to(out.dtype)
    else:
        res[:, _on(g, "row", g.idx[0].astype(np.int64), out.device)] = \
            vals.to(out.dtype)
    return res
