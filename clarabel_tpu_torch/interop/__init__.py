"""Carry one problem's configuration from the reference package to the port.

`from_reference(settings_dict, cone_specs)` takes the reference's settings
as a plain dict (`dataclasses.asdict` of a `clarabel_tpu.Settings`) and its
cones as `(class name, dims or alpha)` tuples, and returns the port's
`Settings` and cone objects.  `solver_from_reference(ref_solver)` carries a
set-up `clarabel_tpu.Solver`'s problem into a port `Solver`.  Plain dicts,
tuples, arrays and attribute reads keep the port free of any import of the
reference package.

The module `cvxpy_interface` holds the cvxpy solver and its data path
(cvxpy itself is an optional dependency, imported there when present).
"""

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..cones import api as cones_api
from ..settings import Settings

_CONE_CLASSES = ("ZeroConeT", "NonnegativeConeT", "SecondOrderConeT",
                 "ExponentialConeT", "PowerConeT", "GenPowerConeT",
                 "PSDTriangleConeT")


def cone_from_tuple(spec: Tuple) -> cones_api.SupportedCone:
    """("SecondOrderConeT", 7) -> SecondOrderConeT(7); the tuple after
    the class name holds the constructor's arguments (none for the
    exponential cone, (alpha, dim2) for the generalized power cone)."""
    name, *args = spec
    if name not in _CONE_CLASSES:
        raise ValueError(f"unknown cone class {name!r}")
    return getattr(cones_api, name)(*args)


def cone_to_tuple(cone) -> Tuple:
    """The inverse of `cone_from_tuple`, for any cone object whose class
    carries one of the reference's cone names (either package's)."""
    name = type(cone).__name__
    if name not in _CONE_CLASSES:
        raise ValueError(f"unknown cone class {name!r}")
    if name == "ExponentialConeT":
        return (name,)
    if name == "PowerConeT":
        return (name, float(cone.alpha))
    if name == "GenPowerConeT":
        return (name, tuple(cone.alpha), int(cone.dim2))
    return (name, int(cone.dim))


def from_reference(settings_dict: dict, cone_specs: Sequence[Tuple]
                   ) -> Tuple[Settings, List[cones_api.SupportedCone]]:
    """The port's (Settings, cones) for the reference's settings dict and
    cone tuples.  Unknown setting names raise ValueError."""
    return (Settings.from_dict(dict(settings_dict)),
            [cone_from_tuple(c) for c in cone_specs])


def solver_from_reference(ref_solver, device=None):
    """A port `Solver` set up on the problem a set-up reference `Solver`
    holds: its P (full symmetric), q, A, b, cones and settings, read as
    plain arrays and tuples.  That is the problem the reference solves,
    after its presolve and chordal decomposition where they ran (so the
    port runs neither again on it)."""
    from ..api import Solver

    settings, cones = from_reference(
        dataclasses.asdict(ref_solver.settings),
        [cone_to_tuple(c) for c in ref_solver.cones])
    return Solver(*(np.array(getattr(ref_solver, k), dtype=np.float64)
                    for k in ("_P_full", "_q", "_A", "_b")),
                  cones, settings, device=device)
