"""Component protocols of the solver core.

The reference defines 9 abstract component types that its solver loop is
written against (reference: src/abstract_types.jl:1-9) so that other
implementations can slot in.  As in the JAX package (`protocols.py`), they
are structural protocols over tuples of tensors and plain functions rather
than abstract classes; here the tensors are torch tensors with a leading
lane axis, and the protocols are realized by these modules:

| reference abstract type | realization here |
|---|---|
| AbstractVariables     | the (x, z, s, τ, κ) fields of `ipm.loop.Carry` |
| AbstractEquilibration | `ipm.equilibration.Equilibration` |
| AbstractResiduals     | `ipm.loop.Residuals` |
| AbstractProblemData   | (P, q, A, b) dense tensors or `linalg.matops.SparseCOO` |
| AbstractKKTSystem     | `ipm.loop.build_solve`'s `make_kkt` closure |
| AbstractKKTSolver     | `kkt.dense` / `kkt.condensed` / `kkt.blockarrow` / `kkt.multifrontal` / `kkt.assembly_maps` |
| AbstractInfo          | `ipm.loop.Info` + `api.DefaultInfo` |
| AbstractSolution      | `api.DefaultSolution` / `parallel.batch_impl.BatchSolution` |
| AbstractSolver        | `api.Solver` / `parallel.batch_impl.BatchSolver` |
"""

from typing import Protocol, Tuple, runtime_checkable


@runtime_checkable
class KKTBackend(Protocol):
    """Contract for a KKT backend: factor at the current scaling state and
    return solve callables, each batched over the lane axis.  Matches the
    tuple that `ipm.loop.build_solve`'s `make_kkt` returns."""

    def __call__(self, P, A, state, factor_dtype, signs) -> Tuple:
        """Returns (ok (B,) bool, solve_xz, solve_xz2)."""
        ...


@runtime_checkable
class ConeGroupOps(Protocol):
    """Contract implemented per cone family (cones.ops / cones.psd /
    cones.nonsymmetric): the ~20-operation interface of the reference
    (reference: src/cones/coneops_defaults.jl:11-314) expressed as
    functions over the lanes' group tensors."""

    def update_scaling(self, g, s, z, mu, strategy):
        ...

    def step_length(self, g, state, dz, ds, z, s):
        ...

    def compute_barrier(self, g, z, s, dz, ds, alpha):
        ...


@runtime_checkable
class SolutionLike(Protocol):
    """AbstractSolution contract (reference: src/types.jl:279-311)."""

    x: object
    z: object
    s: object
    status: object
    obj_val: object
    iterations: object


@runtime_checkable
class SolverLike(Protocol):
    """AbstractSolver contract (reference: src/abstract_types.jl +
    src/solver.jl:5-29): anything that can be set up on conic data and
    produce a SolutionLike."""

    def solve(self):
        ...


@runtime_checkable
class InfoLike(Protocol):
    """AbstractInfo contract (reference: src/types.jl:198-251)."""

    mu: object
    iterations: object
    res_primal: object
    res_dual: object
    status: object
