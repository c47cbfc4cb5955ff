"""CBF (Conic Benchmark Format / CBLIB) reader — scalar conic subset.

The port's copy of the JAX package's `io/cbf.py`, line for line (numpy and
scipy.sparse only; the cones are the port's own), so that both packages
read a file into the same arrays.

The reference's conic benchmark results come from CBLIB instances run
through an external harness (README.md:62-72); it ships no CBF reader
(file-I/O precedent: src/json.jl).  This reader ingests the scalar part
of CBF v1-3: variables/constraints in products of F, L+, L-, L=, Q, QR
and EXP cones, with linear objective.

Conic form mapping (solver form: min qᵀx s.t. Ax + s = b, s ∈ K):
* CBF constraint rows  g = A_c x + b_c ∈ K  become  (−A_c) x + s = b_c.
* CBF variable domains x_block ∈ K become rows  −I x_block + s = 0.
* L− blocks are sign-flipped into L+; QR (rotated SOC) blocks are
  linearly transformed into Q:  (u, v, w) → ((u+v)/√2, (u−v)/√2, w).
* CBF EXP is (x1,x2,x3): x1 ≥ x2·e^{x3/x2} — the reversed triple of the
  solver's ExponentialConeT (z ≥ y·e^{x/y}); rows are permuted.

PSD variables and PSD constraints are supported: PSDVAR blocks become
svec'd variables with PSDTriangleConeT membership rows; PSDCON blocks
become svec'd PSDTriangleConeT constraint rows.  ⟨F, X⟩ couplings use
the standard svec inner product (off-diagonals scaled by √2).  Integer
variables raise NotImplementedError.
"""

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..cones.api import (
    ZeroConeT, NonnegativeConeT, SecondOrderConeT, ExponentialConeT,
    PowerConeT,
)


@dataclasses.dataclass
class CBFProblem:
    name: str
    P: sp.csc_matrix
    q: np.ndarray
    A: sp.csc_matrix
    b: np.ndarray
    cones: list
    obj_constant: float
    obj_sense: float        # +1 MIN, -1 MAX (already folded into q)
    n: int
    m: int

    def solver_args(self):
        return self.P, self.q, self.A, self.b, self.cones


def _read_items(lines, i, count):
    out = []
    while len(out) < count:
        out.extend(lines[i].split())
        i += 1
    return out, i


def load_cbf(path_or_str: str, name: Optional[str] = None) -> CBFProblem:
    if "\n" in path_or_str:
        text = path_or_str
    else:
        with open(path_or_str) as f:
            text = f.read()
    lines = [ln.strip() for ln in text.splitlines()
             if ln.strip() and not ln.strip().startswith("#")]

    obj_sense = 1.0
    var_blocks: List[Tuple[str, int, float]] = []  # (cone, dim, alpha)
    con_blocks: List[Tuple[str, int, float]] = []
    n = 0
    m_cbf = 0
    obj_a: List[Tuple[int, float]] = []
    obj_b = 0.0
    a_coord: List[Tuple[int, int, float]] = []
    b_coord: List[Tuple[int, float]] = []
    pow_params: dict = {}
    psdvar_dims: List[int] = []
    psdcon_dims: List[int] = []
    f_coord: List[Tuple[int, int, int, int, float]] = []  # i, j, r, c, v
    h_coord: List[Tuple[int, int, int, int, float]] = []  # i, j, r, c, v
    d_coord: List[Tuple[int, int, int, float]] = []       # i, r, c, v
    objf_coord: List[Tuple[int, int, int, float]] = []    # j, r, c, v

    i = 0
    while i < len(lines):
        kw = lines[i]
        i += 1
        if kw == "VER":
            i += 1
        elif kw == "OBJSENSE":
            obj_sense = -1.0 if lines[i].upper().startswith("MAX") else 1.0
            i += 1
        elif kw == "POWCONES" or kw == "POW*CONES":
            # v3 parametric power cones: "k total" then per cone a count
            # and that many alpha lines
            hdr = lines[i].split()
            i += 1
            ncones = int(hdr[0])
            for ci in range(ncones):
                cnt = int(lines[i]); i += 1
                alphas = []
                for _ in range(cnt):
                    alphas.append(float(lines[i])); i += 1
                key = ("@%d:POW" % ci) if kw == "POWCONES" else \
                    ("@%d:POW*" % ci)
                pow_params[key] = alphas
        elif kw in ("VAR", "CON"):
            hdr = lines[i].split()
            i += 1
            total, k = int(hdr[0]), int(hdr[1])
            blocks = []
            for _ in range(k):
                toks = lines[i].split()
                i += 1
                blocks.append((toks[0], int(toks[1]), 0.0))
            if kw == "VAR":
                n = total
                var_blocks = blocks
            else:
                m_cbf = total
                con_blocks = blocks
        elif kw in ("INT",):
            raise NotImplementedError("integer variables not supported")
        elif kw in ("PSDVAR", "PSDCON"):
            cnt = int(lines[i]); i += 1
            dims = []
            for _ in range(cnt):
                dims.append(int(lines[i])); i += 1
            if kw == "PSDVAR":
                psdvar_dims = dims
            else:
                psdcon_dims = dims
        elif kw in ("FCOORD", "HCOORD"):
            cnt = int(lines[i]); i += 1
            dst = f_coord if kw == "FCOORD" else h_coord
            for _ in range(cnt):
                t = lines[i].split(); i += 1
                dst.append((int(t[0]), int(t[1]), int(t[2]), int(t[3]),
                            float(t[4])))
        elif kw == "DCOORD":
            cnt = int(lines[i]); i += 1
            for _ in range(cnt):
                t = lines[i].split(); i += 1
                d_coord.append((int(t[0]), int(t[1]), int(t[2]),
                                float(t[3])))
        elif kw == "OBJFCOORD":
            cnt = int(lines[i]); i += 1
            for _ in range(cnt):
                t = lines[i].split(); i += 1
                objf_coord.append((int(t[0]), int(t[1]), int(t[2]),
                                   float(t[3])))
        elif kw == "OBJACOORD":
            cnt = int(lines[i]); i += 1
            for _ in range(cnt):
                toks = lines[i].split(); i += 1
                obj_a.append((int(toks[0]), float(toks[1])))
        elif kw == "OBJBCOORD":
            obj_b = float(lines[i]); i += 1
        elif kw == "ACOORD":
            cnt = int(lines[i]); i += 1
            for _ in range(cnt):
                toks = lines[i].split(); i += 1
                a_coord.append((int(toks[0]), int(toks[1]), float(toks[2])))
        elif kw == "BCOORD":
            cnt = int(lines[i]); i += 1
            for _ in range(cnt):
                toks = lines[i].split(); i += 1
                b_coord.append((int(toks[0]), float(toks[1])))
        else:
            raise ValueError(f"unknown CBF section: {kw}")

    # PSD variables append as svec'd scalar variables after the n scalar
    # ones; svec order matches PSDTriangleConeT (column-stacked upper
    # triangle, off-diagonals ×√2), so ⟨F, X⟩ = svec(F)ᵀ svec(X)
    sqrt2 = math.sqrt(2.0)

    def _svec_idx(r, c):
        i, j = (r, c) if r <= c else (c, r)
        return j * (j + 1) // 2 + i, (1.0 if i == j else sqrt2)

    psd_t = [d * (d + 1) // 2 for d in psdvar_dims]
    pofs = [n + int(s) for s in np.cumsum([0] + psd_t[:-1])] \
        if psd_t else []
    n_tot = n + sum(psd_t)

    # assemble CBF-side data
    if a_coord:
        ai, aj, av = map(np.asarray, zip(*a_coord))
        ai, aj, av = (list(ai.astype(np.int64)), list(aj.astype(np.int64)),
                      list(av))
    else:
        ai, aj, av = [], [], []
    for (ri, vj, r, c, v) in f_coord:   # ⟨F_ij, X_j⟩ into scalar row ri
        idx, mult = _svec_idx(r, c)
        ai.append(ri)
        aj.append(pofs[vj] + idx)
        av.append(v * mult)
    A_c = sp.coo_matrix((av, (ai, aj)), shape=(m_cbf, n_tot)).tocsr()
    b_c = np.zeros(m_cbf)
    for r, v in b_coord:
        b_c[r] += v

    q = np.zeros(n_tot)
    for j, v in obj_a:
        q[j] += obj_sense * v
    for (vj, r, c, v) in objf_coord:
        idx, mult = _svec_idx(r, c)
        q[pofs[vj] + idx] += obj_sense * v * mult

    rows_A: List[sp.csr_matrix] = []
    rows_b: List[np.ndarray] = []
    cones: list = []

    def emit(block_rows_A, block_rows_b, cone, dim, alpha_key=None,
             psd_side=None):
        """Append one cone block given its (dim, n) CBF-side rows G, g
        meaning  G x + g ∈ cone;  solver form rows are (−G) x + s = g."""
        G, g = block_rows_A, block_rows_b
        if cone == "F":
            return  # unconstrained rows carry no information
        if cone == "L-":
            G, g = -G, -g
            cone = "L+"
        if cone == "QR":
            T = sp.eye(dim, format="lil")
            T[0, 0] = T[0, 1] = 1.0 / sqrt2
            T[1, 0] = 1.0 / sqrt2
            T[1, 1] = -1.0 / sqrt2
            T = T.tocsr()
            G, g = T @ G, T @ g
            cone = "Q"
        if cone == "EXP":
            perm = np.arange(dim)[::-1]  # reversed triple
            G, g = G[perm], g[perm]
        rows_A.append(-G)
        rows_b.append(g)
        if cone == "L+":
            cones.append(NonnegativeConeT(dim))
        elif cone == "L=":
            cones.append(ZeroConeT(dim))
        elif cone == "Q":
            cones.append(SecondOrderConeT(dim))
        elif cone == "EXP":
            cones.append(ExponentialConeT())
        elif cone == "PSD":
            from ..cones.api import PSDTriangleConeT

            cones.append(PSDTriangleConeT(psd_side))
        elif cone.endswith(":POW") or cone == "POW":
            alphas = pow_params.get(alpha_key or cone)
            if alphas is None or len(alphas) != 2 or dim != 3:
                raise NotImplementedError(
                    "only 3-d two-parameter power cones supported"
                )
            s = alphas[0] + alphas[1]
            cones.append(PowerConeT(alphas[0] / s))
        else:
            raise NotImplementedError(f"CBF cone {cone} not supported")

    # variable domains: −I x_block + s = 0
    ofs = 0
    eye = sp.eye(n_tot, format="csr")
    for cone, dim, _ in var_blocks:
        if cone != "F":
            emit(eye[ofs:ofs + dim], np.zeros(dim), cone, dim,
                 alpha_key=cone)
        ofs += dim
    if ofs != n:
        raise ValueError("VAR block dims do not sum to the variable count")
    # PSD variable membership: −I over the svec slots, s ∈ PSDTriangle
    for j, d in enumerate(psdvar_dims):
        t = psd_t[j]
        emit(eye[pofs[j]:pofs[j] + t], np.zeros(t), "PSD", t, psd_side=d)

    # constraint rows
    ofs = 0
    for cone, dim, _ in con_blocks:
        emit(A_c[ofs:ofs + dim], b_c[ofs:ofs + dim], cone, dim,
             alpha_key=cone)
        ofs += dim
    if ofs != m_cbf:
        raise ValueError("CON block dims do not sum to the row count")

    # PSD constraint blocks:  svec(Σ_k H_ik x_k + D_i) ∈ PSDTriangle
    for bi, d in enumerate(psdcon_dims):
        t = d * (d + 1) // 2
        gi, gj, gv = [], [], []
        g = np.zeros(t)
        for (ci, vk, r, c, v) in h_coord:
            if ci != bi:
                continue
            idx, mult = _svec_idx(r, c)
            gi.append(idx)
            gj.append(vk)
            gv.append(v * mult)
        for (ci, r, c, v) in d_coord:
            if ci != bi:
                continue
            idx, mult = _svec_idx(r, c)
            g[idx] += v * mult
        G = sp.coo_matrix((gv, (gi, gj)), shape=(t, n_tot)).tocsr()
        emit(G, g, "PSD", t, psd_side=d)

    A = sp.vstack(rows_A).tocsc() if rows_A else sp.csc_matrix((0, n_tot))
    b = np.concatenate(rows_b) if rows_b else np.zeros(0)
    P = sp.csc_matrix((n_tot, n_tot))
    return CBFProblem(
        name=name or "cbf", P=P, q=q, A=A, b=b, cones=cones,
        obj_constant=obj_sense * obj_b, obj_sense=obj_sense,
        n=n_tot, m=A.shape[0],
    )
