"""Make `sparse.npz`, the committed fixture that the port's sparse and
structured `Solver` is held to, in `tests/test_torch_sparse_solver.py`,
`tests/test_torch_solver.py` (the inputs that once raised) and phase [14]
of `chip_smoke.py`.

For each case it stores the problem (P and A as COO triplets with their
shapes and whether they go in as scipy-sparse, q, b, the cones as JSON
tuples), the Settings fields the case sets, and the outputs of
`clarabel_tpu.Solver` on the CPU: status, iterations, objective, x, z, s,
the backend, the plan's type and shapes.  A case with an update also
stores the update and the outputs of the warm re-solve after it.

The small cases are those of `tests/test_sparse_mode.py`,
`tests/test_multifrontal.py`, `tests/test_soc_rank2.py` and
`tests/test_blockarrow_backend.py`, and four inputs the port's dense-only
`Solver` once refused.  The three large ones are [14]'s, at the size the
repository's configurations give (their data is remade from the port's
generators in `clarabel_tpu_torch/bench_data.py`, not stored):

* `grid60`: `benchmarks/grid_qp.py` grid_qp_sparse(60), with
  factor_dtype="float32" (the card's default for these fronts);
* `banded2500`: `benchmarks/configs.py` large_banded_qp_sparse(2500), then
  update_q and update_b and a warm re-solve;
* `rls2000`: `tests/test_soc_rank2.py` robust_ls_banded(2000, 500) with
  sparse_data=True.

Run from the repository root; the small cases take about a minute, the
large ones about five (banded2500's nested-dissection analysis alone takes
two), so name them to make only some:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_sparse_fixtures.py [name ...]

Named cases are merged into the existing file.  This script imports
`clarabel_tpu`, so it lives outside the port package.
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
OUT = os.path.join(HERE, "sparse.npz")
OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val")
LARGE = ("grid60", "banded2500", "rls2000")


def _tuples(cones):
    from clarabel_tpu_torch.interop import cone_to_tuple

    return [cone_to_tuple(c) for c in cones]


def _case(P, q, A, b, cones, sparse_in=True, settings=None, update=None):
    return dict(P=P, q=np.asarray(q, float), A=A, b=np.asarray(b, float),
                cones=_tuples(cones), sparse_in=sparse_in,
                settings=settings or {}, update=update)


def small_cases():
    """name -> case dict, the problems built with the reference's test
    helpers (their cones are the reference's classes)."""
    import scipy.sparse as sp

    import clarabel_tpu as ct
    from test_blockarrow_backend import banded_qp
    from test_chordal import block_arrow_sdp
    from test_multifrontal import grid_qp
    from test_soc_rank2 import robust_ls_banded

    out = {}
    P, q, A, b, cones = banded_qp(grid=20)
    out["dense_match"] = _case(P, q, A, b, cones,
                               settings={"sparse_data": True})
    # test_sparse_mode_auto_threshold's problem class at the smallest size
    # past the threshold (n + m = 2030 > 2000), so the test stays short
    P, q, A, b, cones = banded_qp(grid=290)
    out["auto_threshold"] = _case(P, q, A, b, cones)
    rng = np.random.default_rng(0)
    n = 30
    F = rng.standard_normal((n, n))
    Pf = F @ F.T + np.eye(n)
    Af = np.vstack([rng.standard_normal((5, n)), -np.eye(n)])
    bf = np.concatenate([Af[:5] @ np.ones(n) + 1.0, np.ones(n) * 5])
    out["dense_fallback"] = _case(Pf, rng.standard_normal(n), Af, bf,
                                  [ct.NonnegativeConeT(5 + n)],
                                  settings={"sparse_data": True})
    P, q, A, b, cones = banded_qp(grid=20)
    st = {"sparse_data": True, "presolve_enable": False}
    out["update_bq"] = _case(P, q, A, b, cones, settings=st,
                             update={"q": q + 0.25, "b": b * 0.9})
    out["update_PA"] = _case(P, q, A, b, cones, settings=st, update={
        "P": 2.0 * P, "A_nzval": sp.csc_matrix(1.5 * A).data.astype(float)})
    # test_sparse_mode_with_socs
    grid = 30
    n = 2 * grid
    P, q, A, b, cones = banded_qp(grid=grid)
    rows, bs = [], []
    for k in range(4):
        j = 2 * (k * grid // 4)
        C = np.zeros((3, n))
        C[1, j] = 1.0
        C[2, j + 1] = 1.0
        rows.append(-C)
        bs.append(np.array([3.0, 0.0, 0.0]))
        cones = cones + [ct.SecondOrderConeT(3)]
    out["socs"] = _case(P, q, np.vstack([A] + rows), np.concatenate([b] + bs),
                        cones, settings={"sparse_data": True})
    # test_sparse_mode_with_exp_cones
    P, q, A, b, cones = banded_qp(grid=25)
    n, nt = 50, 2
    P2 = np.zeros((n + nt, n + nt))
    P2[:n, :n] = P
    A2 = np.zeros((A.shape[0], n + nt))
    A2[:, :n] = A
    rows, bs = [], []
    for i in range(nt):
        C = np.zeros((3, n + nt))
        C[0, n + i] = -1.0
        C[2, 4 * i] = -1.0
        rows.append(C)
        bs.append(np.array([0.0, 1.0, 1.0]))
        cones = cones + [ct.ExponentialConeT()]
    out["exp"] = _case(P2, np.concatenate([q, -np.ones(nt)]),
                       np.vstack([A2] + rows), np.concatenate([b] + bs),
                       cones, settings={"sparse_data": True})
    P, q, A, b, cones = block_arrow_sdp(k=120, w=3)
    out["chordal_sparse"] = _case(P, q, A, b, cones, sparse_in=False)
    P, q, A, b, cones = grid_qp(16, seed=6)
    out["grid_sparse"] = _case(P, q, A, b, cones,
                               settings={"sparse_data": True})
    P, q, A, b, cones = grid_qp(17, seed=5)
    out["grid_multifrontal"] = _case(P, q, A, b, cones, sparse_in=False,
                                     settings={"kkt_backend":
                                               "multifrontal"})
    P, q, A, b, cones = grid_qp(24, seed=7)
    out["grid_auto"] = _case(P, q, A, b, cones, sparse_in=False)
    P, q, A, b, cones = banded_qp()
    out["blockarrow_dense"] = _case(P, q, A, b, cones, sparse_in=False,
                                    settings={"kkt_backend": "blockarrow"})
    P, q, A, b, cones, _, _ = robust_ls_banded()
    out["rank2"] = _case(P, q, A, b, cones, settings={"sparse_data": True})
    P, q, A, b, cones, _, _ = robust_ls_banded(m=120, n=40, seed=1)
    out["rank2_dense_input"] = _case(P, q, A, b, cones, sparse_in=False)
    d2 = 60
    nv = 2 + d2
    A = sp.vstack([-sp.eye(nv), sp.coo_matrix(
        ([1.0, 1.0], ([0, 1], [0, 1])), shape=(2, nv))]).tocsr()
    q = np.zeros(nv)
    q[2] = -1.0
    out["lowrank_genpow"] = _case(
        sp.csr_matrix((nv, nv)), q, A,
        np.concatenate([np.zeros(nv), [1.5, 2.0]]),
        [ct.GenPowerConeT([0.4, 0.6], d2), ct.ZeroConeT(2)],
        settings={"sparse_data": True})
    out.update(left_out_cases())
    return out


def left_out_cases():
    """The four inputs of `tests/test_torch_solver.py` that the port's
    dense-only Solver refused (ROADMAP.md Queue 1 item 11)."""
    import scipy.sparse as sp

    import clarabel_tpu as ct

    P = np.array([[4., 1.], [1., 2.]])
    q = np.ones(2)
    A = np.vstack([-np.array([[1., 1.], [1., 0.], [0., 1.]]),
                   np.array([[1., 1.], [1., 0.], [0., 1.]])])
    b = np.array([-1., 0., 0., 1., 0.7, 0.7])
    out = {"left_out_sparse_data": _case(
        P, q, A, b, [ct.NonnegativeConeT(3)] * 2, sparse_in=False,
        settings={"sparse_data": True})}
    n = 1200
    out["left_out_sparse_big"] = _case(
        sp.eye(n, format="csc"), np.ones(n), sp.eye(n, format="csc"),
        np.ones(n), [ct.NonnegativeConeT(n)])
    n, m = 10, 40
    Ad = np.zeros((m, n))
    Ad[np.arange(n), np.arange(n)] = 1.0
    out["left_out_big_soc_sparse_rows"] = _case(
        np.eye(n), np.ones(n), Ad, np.ones(m), [ct.SecondOrderConeT(m)],
        sparse_in=False)
    n = 600
    out["left_out_auto_above_1024"] = _case(
        np.eye(n), np.ones(n), np.vstack([np.eye(n), -np.eye(n)]),
        np.ones(2 * n), [ct.NonnegativeConeT(2 * n)], sparse_in=False)
    return out


def large_cases():
    from clarabel_tpu_torch import bench_data

    P, q, A, b = bench_data.grid_qp_sparse(60)
    from clarabel_tpu_torch.cones.api import NonnegativeConeT

    out = {"grid60": _case(P, q, A, b, [NonnegativeConeT(3600)],
                           settings={"factor_dtype": "float32"})}
    P, q, A, b, cones = bench_data.large_banded_qp_sparse(2500)
    out["banded2500"] = _case(P, q, A, b, cones,
                              update={"q": q + 0.25, "b": b * 0.9})
    P, q, A, b, cones, _, _ = bench_data.robust_ls_banded(m=2000, n=500)
    out["rls2000"] = _case(P, q, A, b, cones,
                           settings={"sparse_data": True})
    return out


def plan_shapes(plan):
    """A plan's shapes: (p, nb, nt) of a BlockArrowPlan, or (cnt, nr, nbd)
    of each level of a NestedPlan."""
    if plan is None:
        return []
    if hasattr(plan, "levels"):
        return [[lv.cnt, lv.nr, lv.nbd] for lv in plan.levels]
    return [[plan.p, plan.nb, plan.nt]]


def true_kkt(P, q, A, b, x, z, s):
    """The 2-norms of the primal and dual residuals of the original problem
    and |s'z|, with P the full symmetric matrix of triu(P)."""
    import scipy.sparse as sp

    U = sp.triu(sp.csr_matrix(P))
    Pf = U + sp.triu(U, 1).T
    A = sp.csr_matrix(A)
    return (float(np.linalg.norm(A @ x + s - b)),
            float(np.linalg.norm(Pf @ x + q + A.T @ z)), float(abs(s @ z)))


def _outputs(solver, sol, case):
    r = {k: np.asarray(getattr(sol, k), dtype=np.float64) for k in OUT_KEYS}
    r["kkt"] = np.asarray(true_kkt(case["P"], case["q_now"], case["A"],
                                   case["b_now"], sol.x, sol.z, sol.s))
    plan = getattr(solver, "_structure", None)
    r["backend"] = np.array(solver._backend)
    r["plan"] = np.array(type(plan).__name__ if plan is not None else "")
    r["plan_shapes"] = np.array(json.dumps(plan_shapes(plan)))
    r["sparse_mode"] = np.array(bool(getattr(solver, "_sparse_mode", False)))
    return r


def reference_outputs(name, case):
    """The reference Solver's outputs on a case (and after its update)."""
    import time

    import clarabel_tpu as ct

    cones = [getattr(ct, t[0])(*t[1:]) for t in case["cones"]]
    P, A = case["P"], case["A"]
    if case["sparse_in"]:
        import scipy.sparse as sp

        P, A = sp.csr_matrix(P), sp.csr_matrix(A)
    else:
        P, A = _dense(P), _dense(A)
    t0 = time.perf_counter()
    solver = ct.Solver(P, case["q"], A, case["b"], cones,
                       ct.Settings(**case["settings"]))
    t1 = time.perf_counter()
    sol = solver.solve()
    now = dict(case, q_now=case["q"], b_now=case["b"])
    r = _outputs(solver, sol, now)
    upd = case["update"]
    if upd is not None:
        import scipy.sparse as sp

        if "P" in upd:
            solver.update_P(sp.csr_matrix(upd["P"]))
            now["P"] = upd["P"]
        if "A_nzval" in upd:
            solver.update_A(upd["A_nzval"])
            Ac = sp.csc_matrix(now["A"]).copy()
            Ac.data = np.asarray(upd["A_nzval"], np.float64)
            now["A"] = Ac
        solver.update_data(q=upd.get("q"), b=upd.get("b"))
        now["q_now"] = upd.get("q", now["q_now"])
        now["b_now"] = upd.get("b", now["b_now"])
        usol = solver.solve()
        r.update({f"upd_{k}": v
                  for k, v in _outputs(solver, usol, now).items()})
    print(f"{name}: {sol.status.name}, {sol.iterations} iterations, "
          f"{solver._backend} {r['plan']} {r['plan_shapes']}, true KKT "
          f"{r['kkt']}, setup {t1 - t0:.1f} s, solve "
          f"{time.perf_counter() - t1:.1f} s",
          flush=True)
    return r


def _dense(M):
    return np.asarray(M.toarray()) if hasattr(M, "toarray") else np.asarray(M)


def _coo(prefix, M):
    import scipy.sparse as sp

    C = sp.coo_matrix(M)
    return {f"{prefix}_row": C.row.astype(np.int64),
            f"{prefix}_col": C.col.astype(np.int64),
            f"{prefix}_val": C.data.astype(np.float64),
            f"{prefix}_shape": np.asarray(C.shape, dtype=np.int64)}


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    cases = dict(small_cases(), **large_cases())
    unknown = set(names) - set(cases)
    if unknown:
        raise SystemExit(f"unknown cases {sorted(unknown)}")
    arrays = dict(np.load(OUT)) if names and os.path.exists(OUT) else {}
    for name, case in cases.items():
        if names and name not in names:
            continue
        for k in list(arrays):
            if k.startswith(name + "_"):
                del arrays[k]
        if name not in LARGE:
            arrays.update(_coo(f"{name}_P", case["P"]))
            arrays.update(_coo(f"{name}_A", case["A"]))
            arrays[f"{name}_q"] = case["q"]
            arrays[f"{name}_b"] = case["b"]
        arrays[f"{name}_cones"] = np.array(json.dumps(case["cones"]))
        arrays[f"{name}_sparse_in"] = np.array(case["sparse_in"])
        arrays[f"{name}_settings"] = np.array(json.dumps(case["settings"]))
        upd = case["update"] or {}
        for k, v in upd.items():
            if k == "P":
                arrays.update(_coo(f"{name}_updarg_P", v))
            else:
                arrays[f"{name}_updarg_{k}"] = np.asarray(v, np.float64)
        for k, v in reference_outputs(name, case).items():
            arrays[f"{name}_{k}"] = v
    np.savez_compressed(OUT, **arrays)


if __name__ == "__main__":
    main(sys.argv[1:])
