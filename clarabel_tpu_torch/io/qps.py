"""QPS (MPS + QUADOBJ) reader: ingest Maros–Mészáros-style QP files.

The port's copy of the JAX package's `io/qps.py`, line for line (numpy and
scipy.sparse only; the cones are the port's own), so that both packages
read a file into the same arrays.

The reference ships no file readers beyond its own JSON schema
(reference: src/json.jl:118-210); its benchmark results on the
Maros–Mészáros set come from the paper's external harness (README.md:62-72).
This reader lets the benchmark suite run real QPS files directly.

Converts

    min ½ xᵀQx + cᵀx
    s.t. L/G/E rows, RANGES, BOUNDS (MPS semantics, default x ≥ 0)

to the solver's conic form

    min ½ xᵀPx + qᵀx   s.t.  Ax + s = b,  s ∈ Zero^meq × NonNeg^mineq.

Supported sections: NAME, ROWS, COLUMNS, RHS, RANGES, BOUNDS,
QUADOBJ/QMATRIX, OBJSENSE, ENDATA.  Free-format (whitespace-separated),
as used by the Maros–Mészáros distribution.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..cones.api import ZeroConeT, NonnegativeConeT

_INF = float("inf")


@dataclasses.dataclass
class QPSProblem:
    name: str
    P: sp.csc_matrix        # (n, n) full symmetric
    q: np.ndarray           # (n,)
    A: sp.csc_matrix        # (m, n)
    b: np.ndarray           # (m,)
    cones: list             # [ZeroConeT(meq), NonnegativeConeT(mineq)]
    obj_constant: float     # add to ½xᵀPx + qᵀx for the MPS objective value
    n: int
    m: int

    def solver_args(self):
        return self.P, self.q, self.A, self.b, self.cones


def _tokens(line: str) -> List[str]:
    return line.split()


def load_qps(path_or_str: str, name: Optional[str] = None) -> QPSProblem:
    """Parse a QPS file (path, or the file contents as a string)."""
    if "\n" in path_or_str or path_or_str.strip().upper().startswith(
            ("NAME", "ROWS")):
        text = path_or_str
    else:
        with open(path_or_str) as f:
            text = f.read()

    section = None
    prob_name = name or "qps"
    obj_row = None
    obj_sense = 1.0  # MIN
    row_type: Dict[str, str] = {}
    row_order: List[str] = []
    col_order: List[str] = []
    col_index: Dict[str, int] = {}
    a_entries: List[Tuple[str, int, float]] = []   # (row, col_idx, val)
    c_lin: Dict[int, float] = {}
    rhs: Dict[str, float] = {}
    obj_rhs = 0.0
    ranges: Dict[str, float] = {}
    lb: Dict[int, float] = {}
    ub: Dict[int, float] = {}
    quad: List[Tuple[int, int, float]] = []
    in_qmatrix = False
    integer_mode = False

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        toks = _tokens(raw)
        if is_header:
            head = toks[0].upper()
            if head == "NAME":
                prob_name = toks[1] if len(toks) > 1 else prob_name
                section = "NAME"
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                if len(toks) > 1:
                    obj_sense = -1.0 if toks[1].upper().startswith("MAX") else 1.0
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                          "QUADOBJ", "QMATRIX", "ENDATA"):
                section = head
                in_qmatrix = head == "QMATRIX"
                if head == "ENDATA":
                    break
            else:
                raise ValueError(f"unknown QPS section: {head}")
            continue

        if section == "OBJSENSE":
            obj_sense = -1.0 if toks[0].upper().startswith("MAX") else 1.0
        elif section == "ROWS":
            rt, rname = toks[0].upper(), toks[1]
            if rt == "N":
                if obj_row is None:
                    obj_row = rname
                # extra free rows are ignored
            else:
                if rt not in ("L", "G", "E"):
                    raise ValueError(f"unknown row type {rt}")
                row_type[rname] = rt
                row_order.append(rname)
        elif section == "COLUMNS":
            cname = toks[0]
            if toks[1].upper() == "'MARKER'" if len(toks) > 1 else False:
                kw = toks[2].upper().strip("'") if len(toks) > 2 else ""
                integer_mode = kw == "INTORG"
                continue
            if cname not in col_index:
                col_index[cname] = len(col_order)
                col_order.append(cname)
            j = col_index[cname]
            for k in range(1, len(toks) - 1, 2):
                rname, val = toks[k], float(toks[k + 1])
                if rname == obj_row:
                    c_lin[j] = c_lin.get(j, 0.0) + val
                else:
                    a_entries.append((rname, j, val))
        elif section == "RHS":
            # first token is the RHS set name (may be omitted in the wild
            # when the line has an even token count)
            start = 1 if len(toks) % 2 == 1 else 0
            for k in range(start, len(toks) - 1, 2):
                rname, val = toks[k], float(toks[k + 1])
                if rname == obj_row:
                    obj_rhs = val
                else:
                    rhs[rname] = val
        elif section == "RANGES":
            start = 1 if len(toks) % 2 == 1 else 0
            for k in range(start, len(toks) - 1, 2):
                ranges[toks[k]] = float(toks[k + 1])
        elif section == "BOUNDS":
            btype = toks[0].upper()
            # "BND  COL  VAL" vs "BND_SET  COL  VAL": bound lines are
            # TYPE SETNAME COLNAME [VALUE]
            cname = toks[2] if len(toks) > 2 else toks[1]
            if cname not in col_index:
                col_index[cname] = len(col_order)
                col_order.append(cname)
            j = col_index[cname]
            val = float(toks[3]) if len(toks) > 3 else 0.0
            if btype == "LO":
                lb[j] = val
            elif btype == "UP":
                ub[j] = val
                # MPS quirk: UP with negative value and no explicit LO
                # makes the lower bound -inf
                if val < 0 and j not in lb:
                    lb[j] = -_INF
            elif btype == "FX":
                lb[j] = val
                ub[j] = val
            elif btype == "FR":
                lb[j] = -_INF
                ub[j] = _INF
            elif btype == "MI":
                lb[j] = -_INF
            elif btype == "PL":
                ub[j] = _INF
            elif btype in ("BV", "LI", "UI"):
                raise ValueError(f"integer bound type {btype} not supported")
            else:
                raise ValueError(f"unknown bound type {btype}")
        elif section in ("QUADOBJ", "QMATRIX"):
            c1, c2, val = toks[0], toks[1], float(toks[2])
            i, j = col_index[c1], col_index[c2]
            quad.append((i, j, val))

    if integer_mode:
        raise ValueError("integer variables not supported")

    n = len(col_order)
    m_rows = len(row_order)

    # objective: MPS QUADOBJ lists each off-diagonal once for ½xᵀQx with
    # implied symmetry; QMATRIX lists the full matrix
    qi = np.array([e[0] for e in quad], dtype=np.int64)
    qj = np.array([e[1] for e in quad], dtype=np.int64)
    qv = np.array([e[2] for e in quad])
    Q = sp.coo_matrix((qv, (qi, qj)), shape=(n, n)).tocsr()
    if in_qmatrix or section == "QMATRIX" or (
            len(quad) and _is_symmetric_listing(qi, qj)):
        P = Q
    else:
        # QUADOBJ: symmetrize the one-sided listing
        D = sp.diags(Q.diagonal())
        P = Q + Q.T - D
    P = (obj_sense * P).tocsc()

    q = np.zeros(n)
    for j, v in c_lin.items():
        q[j] = obj_sense * v

    # constraint rows
    row_index = {r: i for i, r in enumerate(row_order)}
    ai = np.array([row_index[e[0]] for e in a_entries], dtype=np.int64)
    aj = np.array([e[1] for e in a_entries], dtype=np.int64)
    av = np.array([e[2] for e in a_entries])
    Araw = sp.coo_matrix((av, (ai, aj)), shape=(m_rows, n)).tocsr()

    eq_rows: List[int] = []
    eq_b: List[float] = []
    ineq_blocks: List[sp.csr_matrix] = []
    ineq_b: List[float] = []

    def add_ineq(row_vec, bval):
        ineq_blocks.append(row_vec)
        ineq_b.append(bval)

    for rname in row_order:
        i = row_index[rname]
        rt = row_type[rname]
        rv = rhs.get(rname, 0.0)
        arow = Araw.getrow(i)
        rng = ranges.get(rname)
        if rt == "E" and rng is None:
            eq_rows.append(i)
            eq_b.append(rv)
            continue
        # interval [lo, hi] per MPS RANGES semantics
        if rt == "L":
            hi = rv
            lo = rv - abs(rng) if rng is not None else -_INF
        elif rt == "G":
            lo = rv
            hi = rv + abs(rng) if rng is not None else _INF
        else:  # E with range
            if rng >= 0:
                lo, hi = rv, rv + rng
            else:
                lo, hi = rv + rng, rv
        if hi < _INF:
            add_ineq(arow, hi)            # aᵀx ≤ hi
        if lo > -_INF:
            add_ineq(-arow, -lo)          # −aᵀx ≤ −lo

    # variable bounds (default 0 ≤ x < ∞)
    eye = sp.eye(n, format="csr")
    for j in range(n):
        l = lb.get(j, 0.0)
        u = ub.get(j, _INF)
        if u < _INF:
            add_ineq(eye.getrow(j), u)
        if l > -_INF:
            add_ineq(-eye.getrow(j), -l)

    blocks = []
    bvals = []
    meq = len(eq_rows)
    if meq:
        blocks.append(Araw[eq_rows])
        bvals.append(np.asarray(eq_b))
    mineq = len(ineq_blocks)
    if mineq:
        blocks.append(sp.vstack(ineq_blocks))
        bvals.append(np.asarray(ineq_b))
    A = (sp.vstack(blocks).tocsc() if blocks
         else sp.csc_matrix((0, n)))
    b = np.concatenate(bvals) if bvals else np.zeros(0)

    cones = []
    if meq:
        cones.append(ZeroConeT(meq))
    if mineq:
        cones.append(NonnegativeConeT(mineq))

    return QPSProblem(
        name=prob_name, P=P, q=q, A=A, b=b, cones=cones,
        obj_constant=-obj_sense * obj_rhs, n=n, m=A.shape[0],
    )


def _is_symmetric_listing(qi, qj) -> bool:
    """True if the quad section lists both (i,j) and (j,i) for
    off-diagonals (i.e. it is a full-matrix listing)."""
    off = {(int(i), int(j)) for i, j in zip(qi, qj) if i != j}
    if not off:
        return False
    return all((j, i) in off for (i, j) in off)
