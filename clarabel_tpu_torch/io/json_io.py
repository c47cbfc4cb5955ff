"""Clarabel-compatible JSON problem save/load.

Round-trips problems in the reference's JSON schema (reference:
src/json.jl:25-87 save, :118-210 load): 0-based CSC matrices for P (triu)
and A, vectors q and b, a cone-spec list, and sanitized settings.  Lets
this solver ingest problems written by Clarabel.jl and vice versa, and a
file written by either `clarabel_tpu` or this package loads in the other.
A copy of `clarabel_tpu/io/json_io.py` over the port's classes; it reads
and writes its CSC matrices through scipy.sparse, the one module of the
port that needs scipy.
"""

import dataclasses
import json
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..settings import Settings
from ..cones import api as cone_api


def _csc_to_dict(M: sp.csc_matrix) -> dict:
    M = sp.csc_matrix(M)
    return {
        "m": int(M.shape[0]),
        "n": int(M.shape[1]),
        "colptr": M.indptr.astype(int).tolist(),
        "rowval": M.indices.astype(int).tolist(),
        "nzval": np.asarray(M.data, dtype=float).tolist(),
    }


def _csc_from_dict(d: dict) -> sp.csc_matrix:
    return sp.csc_matrix(
        (np.asarray(d["nzval"], dtype=np.float64),
         np.asarray(d["rowval"], dtype=np.int64),
         np.asarray(d["colptr"], dtype=np.int64)),
        shape=(d["m"], d["n"]),
    )


_CONE_TO_JSON = {
    cone_api.ZeroConeT: "ZeroConeT",
    cone_api.NonnegativeConeT: "NonnegativeConeT",
    cone_api.SecondOrderConeT: "SecondOrderConeT",
    cone_api.ExponentialConeT: "ExponentialConeT",
    cone_api.PowerConeT: "PowerConeT",
    cone_api.GenPowerConeT: "GenPowerConeT",
    cone_api.PSDTriangleConeT: "PSDTriangleConeT",
}


def _cone_to_dict(c) -> dict:
    name = _CONE_TO_JSON[type(c)]
    if isinstance(c, cone_api.ExponentialConeT):
        return {name: {}}
    if isinstance(c, cone_api.PowerConeT):
        return {name: c.alpha}
    if isinstance(c, cone_api.GenPowerConeT):
        return {name: [list(c.alpha), c.dim2]}
    return {name: c.dim}


def _cone_from_dict(d: dict):
    (name, val), = d.items()
    if name == "ZeroConeT":
        return cone_api.ZeroConeT(int(val))
    if name == "NonnegativeConeT":
        return cone_api.NonnegativeConeT(int(val))
    if name == "SecondOrderConeT":
        return cone_api.SecondOrderConeT(int(val))
    if name == "ExponentialConeT":
        return cone_api.ExponentialConeT()
    if name == "PowerConeT":
        return cone_api.PowerConeT(float(val))
    if name == "GenPowerConeT":
        alpha, dim2 = val
        return cone_api.GenPowerConeT(tuple(alpha), int(dim2))
    if name == "PSDTriangleConeT":
        return cone_api.PSDTriangleConeT(int(val))
    raise ValueError(f"unknown cone type in JSON: {name}")


def save_to_file(solver, filename: str) -> None:
    """Write the (un-equilibrated) problem data + settings to JSON: the
    problem the solver solves, after presolve and chordal decomposition
    where they ran (as the reference writes it)."""
    # triu of a dense P or of the sparse mode's csr P
    P = sp.csc_matrix(sp.triu(sp.csc_matrix(solver._P_full)))
    A = sp.csc_matrix(solver._A)
    payload = {
        "P": _csc_to_dict(P),
        "q": solver._q.tolist(),
        "A": _csc_to_dict(A),
        "b": solver._b.tolist(),
        "cones": [_cone_to_dict(c) for c in solver.cones],
        "settings": _sanitize_settings(solver.settings),
    }
    with open(filename, "w") as f:
        json.dump(payload, f)


def load_from_file(filename: str, settings: Optional[Settings] = None,
                   device=None):
    """Read a JSON problem file and return a fresh, setup Solver on
    `device` (the card when None; "cpu" for the plain versions)."""
    from ..api import Solver

    with open(filename) as f:
        d = json.load(f)
    P = _csc_from_dict(d["P"])
    A = _csc_from_dict(d["A"])
    q = np.asarray(d["q"], dtype=np.float64)
    b = np.asarray(d["b"], dtype=np.float64)
    cones = [_cone_from_dict(c) for c in d["cones"]]
    if settings is None:
        settings = _settings_from_dict(d.get("settings", {}))
    return Solver(P, q, A, b, cones, settings, device=device)


def _sanitize_settings(settings: Settings) -> dict:
    d = dataclasses.asdict(settings)
    out = {}
    for k, v in d.items():
        if isinstance(v, float) and not np.isfinite(v):
            v = None  # JSON-sanitize infinities (reference: json.jl:91-111)
        out[k] = v
    return out


def _settings_from_dict(d: dict) -> Settings:
    valid = {f.name for f in dataclasses.fields(Settings)}
    # Optional fields where None is a real value (auto-resolution flags),
    # not a sanitized infinity: every field whose default is None (the
    # reference lists three and reads dense_solve_via_inverse and
    # dense_ldl_diag_order back as inf; DEVIATIONS.md #17)
    none_ok = {f.name for f in dataclasses.fields(Settings)
               if f.default is None}
    kw = {}
    for k, v in d.items():
        if k not in valid:
            continue  # ignore settings owned by other implementations
        if v is None and k not in none_ok:
            v = float("inf")
        kw[k] = v
    return Settings(**kw)
