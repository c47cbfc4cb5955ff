"""User-facing cone specification types.

Mirrors the SupportedCone API of the reference (reference:
src/cones/cone_api.jl:18-74) including `nvars` slack counting and the
v0.11 cone-collapsing pass (reference: src/cones/cone_api.jl:96-153).
"""

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


class SupportedCone:
    """Marker base class for cone specifications."""


@dataclasses.dataclass(frozen=True)
class ZeroConeT(SupportedCone):
    dim: int


@dataclasses.dataclass(frozen=True)
class NonnegativeConeT(SupportedCone):
    dim: int


@dataclasses.dataclass(frozen=True)
class SecondOrderConeT(SupportedCone):
    dim: int


@dataclasses.dataclass(frozen=True)
class ExponentialConeT(SupportedCone):
    pass  # dim = 3 always


@dataclasses.dataclass(frozen=True)
class PowerConeT(SupportedCone):
    alpha: float  # dim = 3 always


@dataclasses.dataclass(frozen=True)
class GenPowerConeT(SupportedCone):
    alpha: Tuple[float, ...]
    dim2: int

    def __post_init__(self):
        a = np.asarray(self.alpha, dtype=np.float64)
        if not np.all(a > 0):
            raise ValueError("GenPowerConeT alpha entries must be positive")
        if not np.isclose(a.sum(), 1.0, atol=np.finfo(np.float64).eps * len(a) / 2 + 1e-12):
            raise ValueError("GenPowerConeT alpha must sum to 1")
        object.__setattr__(self, "alpha", tuple(float(x) for x in a))


@dataclasses.dataclass(frozen=True)
class PSDTriangleConeT(SupportedCone):
    dim: int  # side dimension of the matrix; nvars = dim*(dim+1)/2


def triangular_number(k: int) -> int:
    return (k * (k + 1)) // 2


def nvars(cone: SupportedCone) -> int:
    """Number of slack variables generated by the cone.

    reference: src/cones/cone_api.jl:61-74
    """
    if isinstance(cone, PSDTriangleConeT):
        return triangular_number(cone.dim)
    if isinstance(cone, (ExponentialConeT, PowerConeT)):
        return 3
    if isinstance(cone, GenPowerConeT):
        return len(cone.alpha) + cone.dim2
    return cone.dim


def cone_degree(cone: SupportedCone) -> int:
    """Barrier degree of the cone."""
    if isinstance(cone, ZeroConeT):
        return 0
    if isinstance(cone, SecondOrderConeT):
        return 1
    if isinstance(cone, PSDTriangleConeT):
        return cone.dim
    if isinstance(cone, (ExponentialConeT, PowerConeT)):
        return 3
    if isinstance(cone, GenPowerConeT):
        return len(cone.alpha) + 1  # reference: coneops_genpowcone.jl:11
    return cone.dim  # Nonnegative


def cone_is_symmetric(cone: SupportedCone) -> bool:
    # the zero cone reports symmetric (reference: coneops_zerocone.jl:14)
    return isinstance(cone, (ZeroConeT, NonnegativeConeT, SecondOrderConeT, PSDTriangleConeT))


def cones_collapse(cones: Sequence[SupportedCone]) -> List[SupportedCone]:
    """Drop empty cones and merge runs of Nonnegative cones and 1-dim SOC/PSD
    singletons into single NonnegativeConeT blocks.

    reference: src/cones/cone_api.jl:96-153 (cones_new_collapsed)
    """

    def collapsible(c: SupportedCone) -> bool:
        return (
            isinstance(c, NonnegativeConeT)
            or (isinstance(c, SecondOrderConeT) and c.dim == 1)
            or (isinstance(c, PSDTriangleConeT) and c.dim == 1)
        )

    out: List[SupportedCone] = []
    i, n = 0, len(cones)
    while i < n:
        cone = cones[i]
        if nvars(cone) == 0:
            i += 1
            continue
        if collapsible(cone):
            total = nvars(cone)
            i += 1
            while i < n and (nvars(cones[i]) == 0 or collapsible(cones[i])):
                total += nvars(cones[i])
                i += 1
            out.append(NonnegativeConeT(total))
        else:
            out.append(cone)
            i += 1
    return out
