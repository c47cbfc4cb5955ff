"""Make the committed fixtures that `tests/test_torch_solver.py` holds the
port's single-instance `Solver` against:

* `solver.npz`: for each case below, its problem data (P, q, A, b; the
  cones as JSON tuples) and the outputs of `clarabel_tpu.Solver` under
  `Settings()` on the CPU: status, iterations, x, z, s, objectives, and
  whether presolve or the chordal decomposition engaged;
* `solver_ref.json`: the "soc" case written by `clarabel_tpu.save_to_file`,
  which the port must load.

The cases: the verify drive (the repository's verification recipe); feasible
problems built as `tests/test_conformance.py` builds them (b = A x0 + s0
with s0 primal-interior, q = -(P x0 + A'z0) with z0 dual-interior) on
second-order, exponential, power, generalized power, PSD and zero cones;
a primal-infeasible problem (two contradictory halfspaces) and a
dual-infeasible LP; the verify drive with an infinite bound (presolve);
and the chordal SDP of `tests/test_chordal.py`.

Run from the repository root (the JAX compiles take a few minutes):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_solver_fixtures.py

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
ROOT = os.path.dirname(TESTS)
for _p in (ROOT, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)
OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual")


def verify_problem():
    """The verification recipe's problem: x = [0.3, 0.7],
    objective 1.88."""
    P = np.array([[4., 1.], [1., 2.]])
    q = np.ones(2)
    A = np.vstack([-np.array([[1., 1.], [1., 0.], [0., 1.]]),
                   np.array([[1., 1.], [1., 0.], [0., 1.]])])
    b = np.concatenate([-np.array([1., 0, 0]), np.array([1., 0.7, 0.7])])
    return P, q, A, b, [("NonnegativeConeT", 3), ("NonnegativeConeT", 3)]


def feasible_problem(cones, rng, quad=True):
    """`make_feasible_problem` of tests/test_conformance.py, over the
    reference's cone objects."""
    from conic_check import interior_dual_point, interior_point
    from clarabel_tpu.cones.api import nvars

    m = sum(nvars(c) for c in cones)
    n = max(3, m // 2)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    if quad:
        F = rng.standard_normal((n, n)) / np.sqrt(n)
        P = F @ F.T + 0.1 * np.eye(n)
    else:
        P = np.zeros((n, n))
    x0 = rng.standard_normal(n) * 0.3
    s0 = np.concatenate([interior_point(c, rng) for c in cones])
    z0 = np.concatenate([interior_dual_point(c, rng) for c in cones])
    b = A @ x0 + s0
    q = -(P @ x0 + A.T @ z0)
    return P, q, A, b


def cases():
    """name -> (P, q, A, b, cone tuples).  Imports the reference's cone
    classes (for the interior points of tests/conic_check.py)."""
    import clarabel_tpu as ct
    from clarabel_tpu_torch.interop import cone_to_tuple
    from test_chordal import sdp_chordal_data

    out = {"verify": verify_problem()}
    families = {
        "soc": [ct.SecondOrderConeT(4), ct.NonnegativeConeT(3)],
        "exp": [ct.ExponentialConeT(), ct.NonnegativeConeT(2)],
        "pow": [ct.PowerConeT(0.6), ct.NonnegativeConeT(2)],
        "genpow": [ct.GenPowerConeT([0.3, 0.7], 2), ct.NonnegativeConeT(2)],
        "psd": [ct.PSDTriangleConeT(3), ct.NonnegativeConeT(2)],
        "zero": [ct.ZeroConeT(2), ct.NonnegativeConeT(3),
                 ct.SecondOrderConeT(3)],
    }
    for i, (name, cones) in enumerate(families.items()):
        rng = np.random.default_rng(100 + i)
        out[name] = feasible_problem(cones, rng) + (
            [cone_to_tuple(c) for c in cones],)
    # primal infeasible: a'x <= 0 and a'x >= 1 (tests/test_conformance.py)
    rng = np.random.default_rng(42)
    cones = [ct.SecondOrderConeT(3)]
    P, q, A, b = feasible_problem(cones, rng, quad=False)
    a = rng.standard_normal(A.shape[1])
    out["primal_infeasible"] = (
        P, q, np.vstack([A, a, -a]), np.concatenate([b, [0.0], [-1.0]]),
        [("SecondOrderConeT", 3), ("NonnegativeConeT", 2)])
    # dual infeasible: an unbounded LP
    out["dual_infeasible"] = (np.zeros((3, 3)), np.array([-1.0, 0.0, 0.0]),
                              -np.eye(3), np.zeros(3),
                              [("NonnegativeConeT", 3)])
    # presolve: an infinite bound on a nonnegative row
    P, q, A, b, cones = verify_problem()
    b = b.copy()
    b[4] = 1e25
    out["presolve"] = (P, q, A, b, cones)
    P, q, A, b, cones = sdp_chordal_data()
    out["chordal"] = (P, q, A, b, [cone_to_tuple(c) for c in cones])
    return out


def reference_outputs(names=None):
    """name -> the reference Solver's outputs on that case."""
    import clarabel_tpu as ct

    res = {}
    for name, (P, q, A, b, tuples) in cases().items():
        if names is not None and name not in names:
            continue
        cones = [getattr(ct, t[0])(*t[1:]) for t in tuples]
        solver = ct.Solver(P, q, A, b, cones, ct.Settings())
        sol = solver.solve()
        r = {k: np.asarray(getattr(sol, k), dtype=np.float64)
             for k in OUT_KEYS}
        r["presolved"] = np.asarray(solver.presolver is not None)
        r["chordal"] = np.asarray(solver.chordal_info is not None)
        res[name] = r
        print(name, sol.status, sol.iterations, flush=True)
    return res


def main():
    import clarabel_tpu as ct

    all_cases = cases()
    res = reference_outputs()
    arrays = {}
    for name, (P, q, A, b, tuples) in all_cases.items():
        for k, v in zip("PqAb", (P, q, A, b)):
            arrays[f"{name}_{k}"] = v
        arrays[f"{name}_cones"] = np.array(json.dumps(tuples))
        for k, v in res[name].items():
            arrays[f"{name}_{k}"] = v
    np.savez(os.path.join(HERE, "solver.npz"), **arrays)
    P, q, A, b, tuples = all_cases["soc"]
    cones = [getattr(ct, t[0])(*t[1:]) for t in tuples]
    ct.save_to_file(ct.Solver(P, q, A, b, cones, ct.Settings()),
                    os.path.join(HERE, "solver_ref.json"))


if __name__ == "__main__":
    main()
