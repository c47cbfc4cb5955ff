"""Make the committed fixtures that hold the port's long solves, its
warm-up and its BASELINE runner to the JAX package:

* `long.npz`:
  - `state_<case>_<field>`: the reference `Solver`'s IPM state (the
    fields of its `ipm.loop.Carry`) after `_chunk_fn(data, carry0, 3)`,
    three IPM iterations from the initial point, on `basic_qp` (the
    problem of `tests/fixtures.py` `basic_qp_data`, the verify drive of
    the verification recipe) under `Settings()` and on the verify drive
    under `Settings(mixed_precision=True)` (`verify_mixed`);
  - `<path>_<case>_<output>` for `path` in one_shot, chunked (a finite
    time_limit), resumed (a checkpoint after three iterations, then
    `resume_from_checkpoint`) and timed (`timing=True`): status,
    iterations, x, z, s, obj_val;
  - `row_<key>_<output>` and `quick_<key>_<output>`: the reference
    `Solver`'s outputs (status, iterations, obj_val, x, r_prim, r_dual) on
    each single-instance row of `benchmarks/run_all.py`, at full scale and
    at its `--quick` scale (the four committed `benchmarks/data/*.qps`
    files, which this script reads and never writes, the Markowitz,
    CVXQP-style, AUG2DC-style, robust least-squares and max-cut rows);
  - `spread_<prefix>_<key>_<dx|dobj|dit|kkt>`: the reference's own
    spread on each of those rows under three 1e-15 changes of q, and its
    largest true-KKT residual there (`spread_outputs`);
  - `batched_solved` and `quick_batched_solved`: the reference
    `BatchSolver`'s SOLVED count on `configs.batched_socp(4096, 6)` and
    at the quick scale (1024 lanes);
  - `builder_<case>_<output>` (status, x): the reference
    `modeling.ProblemBuilder` solves of `builder_calls`, the calls of
    `tests/test_modeling.py`;
  - `conic_<case>_<output>` (status, iterations, x, z, obj_val): the
    reference's cvxpy data path, `solve_conic_data`, on `conic_cases`,
    the cases of `tests/test_cvxpy_interface.py:27-130`;
* `long.json`: the reference `precompile.warmup()` statuses, by family,
  as status names.

Run from the repository root (the reference's CPU compiles and the
full-scale rows take several minutes):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_long_fixtures.py \
        [long] [rows] [spread] [batched] [modeling] [warmup]

With sections named, only those are made again and the rest of the files
is kept.

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
ROOT = os.path.dirname(TESTS)
for _p in (ROOT, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

OUT_KEYS = ("status", "iterations", "x", "z", "s", "obj_val")
ROW_KEYS = ("status", "iterations", "obj_val", "x", "r_prim", "r_dual")
QPS_FILES = ("AUG2DC_style.qps", "CVXQP1_style.qps", "CVXQP2_style.qps",
             "CVXQP3_style.qps")
CAP = 3


def long_cases():
    """name -> (P, q, A, b, reference cones, settings kwargs)."""
    from fixtures import basic_qp_data

    P, q, A, b, cones = basic_qp_data()
    return {"basic_qp": (P, q, A, b, cones, {}),
            "verify_mixed": (P, q, A, b, cones,
                             {"mixed_precision": True})}


def rows(scale):
    """key -> generator of (P, q, A, b, cones), the reference runner's
    single-instance rows at `scale`."""
    from benchmarks import configs
    from clarabel_tpu.io.qps import load_qps

    out = {}
    for fname in QPS_FILES:
        def gen(path=os.path.join(ROOT, "benchmarks", "data", fname)):
            p = load_qps(path)
            return p.P.toarray(), p.q, p.A.toarray(), p.b, p.cones

        out[fname.split("_")[0].lower()] = gen
    out["markowitz"] = lambda: configs.markowitz_qp(
        n_assets=int(200 * scale) or 50)
    out["cvxqp"] = lambda: configs.cvxqp_style(n=int(200 * scale) or 50)
    out["aug2d"] = lambda: configs.aug2d_style(grid=int(10 * scale) or 5)
    out["robust_ls"] = lambda: configs.robust_least_squares_socp(
        m=int(2000 * scale), n=int(500 * scale))
    out["maxcut"] = lambda: configs.maxcut_sdp(nv=int(60 * scale) or 20)
    return out


def builder_calls(B, name):
    """The builder calls of tests/test_modeling.py on builder class B (and
    one call of every other method, `every_method`, not solved)."""
    if name == "qp_box":
        n = 4
        return (B(n).minimize(P=np.eye(n),
                              q=np.array([-1.0, -2.0, 0.5, 0.0]))
                .add_equality(np.ones((1, n)), [1.0])
                .add_bound_box(lb=0.0, ub=0.6))
    if name == "soc_norm":
        n = 3
        C = np.vstack([np.zeros((1, n)), np.eye(n)])
        d = np.zeros(n + 1)
        d[0] = 1.0
        return B(n).minimize(q=np.array([1.0, -2.0, 2.0])).add_soc(C, d)
    if name == "psd_block":
        return (B(3).minimize(q=np.array([1.0, 0.0, 1.0]))
                .add_psd(np.eye(3), -np.array([1.0, 0.0, 1.0])))
    n = 3
    rows = np.vstack([np.eye(n)[:2], np.zeros((1, n))])
    return (B(n).minimize(P=np.eye(n), q=np.ones(n))
            .add_inequality(np.ones((1, n)), [2.0])
            .add_bound_box(lb=[-1.0, -np.inf, -2.0], ub=np.inf)
            .add_exp(rows, [0.0, 0.0, 1.0])
            .add_pow(rows, [1.0, 1.0, 0.0], 0.4)
            .add_genpow(rows, [1.0, 1.0, 0.0], [0.3, 0.7], 1))


BUILDER_CASES = ("qp_box", "soc_norm", "psd_block", "every_method")
SOLVED_BUILDER_CASES = BUILDER_CASES[:3]


def conic_cases():
    """name -> (A, b, c, P, dims, solver_opts): the cases of
    tests/test_cvxpy_interface.py:27-130 in cvxpy's standard form."""
    p = np.array([1.0, 2.0, 3.0])
    A_soc = np.zeros((5, 4))
    b_soc = np.zeros(5)
    A_soc[0, :3] = 1.0
    b_soc[0] = 1.0
    A_soc[1, 3] = -1.0
    A_soc[2:, :3] = -np.eye(3)
    b_soc[2:] = -p
    return {
        "lp": (np.array([[-1.0, -2.0], [-1.0, 0.0], [0.0, -1.0]]),
               np.array([-1.0, 0.0, 0.0]), np.array([1.0, 1.0]), None,
               {"l": 3}, None),
        "socp_zero": (A_soc, b_soc, np.array([0.0, 0.0, 0.0, 1.0]), None,
                      {"z": 1, "q": [4]}, None),
        "infeasible": (np.array([[-1.0], [1.0]]), np.array([-1.0, 0.0]),
                       np.array([1.0]), None, {"l": 2}, None),
        "quad_obj": (-np.eye(2), np.zeros(2), np.array([-2.0, -4.0]),
                     2.0 * np.eye(2), {"l": 2}, {"max_iter": 60}),
    }


def modeling_outputs(arrays):
    from clarabel_tpu.interop import cvxpy_interface as ci
    from clarabel_tpu.modeling import ProblemBuilder

    for name in SOLVED_BUILDER_CASES:
        sol = builder_calls(ProblemBuilder, name).solve()
        arrays[f"builder_{name}_status"] = np.asarray(int(sol.status))
        arrays[f"builder_{name}_x"] = np.asarray(sol.x, dtype=np.float64)
        print("builder", name, sol.status, flush=True)
    for name, (A, b, c, P, dims, opts) in conic_cases().items():
        sol = ci.solve_conic_data(A, b, c, P, dims, solver_opts=opts)
        for k, v in solution_arrays(sol).items():
            arrays[f"conic_{name}_{k}"] = v
        print("conic", name, sol.status, flush=True)


def solution_arrays(sol):
    return {k: np.asarray(getattr(sol, k), dtype=np.float64)
            for k in OUT_KEYS}


def long_outputs(arrays):
    import jax.numpy as jnp

    import clarabel_tpu as ct

    for name, (P, q, A, b, cones, kw) in long_cases().items():
        st = ct.Settings(**kw)
        one = ct.Solver(P, q, A, b, cones, st).solve()
        s = ct.Solver(P, q, A, b, cones, st)
        data, carry = s._prepare_fn(s._P_full, s._q, s._A, s._b)
        carry = s._chunk_fn(data, carry, jnp.asarray(CAP, jnp.int32))
        for k, v in carry._asdict().items():
            arrays[f"state_{name}_{k}"] = np.asarray(v)
        s._last_carry = carry
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "state.npz")
            s.save_checkpoint(path)
            resumed = s.resume_from_checkpoint(path)
        chunked = ct.Solver(P, q, A, b, cones,
                            ct.Settings(time_limit=600.0, **kw)).solve()
        timed = ct.Solver(P, q, A, b, cones,
                          ct.Settings(timing=True, **kw)).solve()
        for path, sol in (("one_shot", one), ("chunked", chunked),
                          ("resumed", resumed), ("timed", timed)):
            for k, v in solution_arrays(sol).items():
                arrays[f"{path}_{name}_{k}"] = v
        print(name, one.status, one.iterations, resumed.iterations,
              flush=True)


def row_outputs(arrays):
    import clarabel_tpu as ct

    for prefix, scale in (("quick", 0.25), ("row", 1.0)):
        for key, gen in rows(scale).items():
            t0 = time.perf_counter()
            P, q, A, b, cones = gen()
            sol = ct.Solver(P, q, A, b, cones, ct.Settings()).solve()
            for k in ROW_KEYS:
                arrays[f"{prefix}_{key}_{k}"] = np.asarray(
                    getattr(sol, k), dtype=np.float64)
            print(prefix, key, sol.status, sol.iterations,
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


JITTER_SEEDS = (7, 8, 9)


def spread_outputs(arrays):
    """The reference's own spread on each row: its solution again with q
    moved by 1e-15 (relative; q * (1 + 1e-15 xi), xi standard normal from
    each of JITTER_SEEDS), against its solution: the largest |dx| relative
    to max(1, |x|inf), |dobj| relative to max(1, |obj|) and |diterations|
    over the seeds (`spread_<prefix>_<key>_dx`, `_dobj`, `_dit`), and the
    largest true-KKT residual (2-norms of Ax + s - b and Px + q + A'z) of
    the solution and the moved ones (`_kkt`)."""
    import clarabel_tpu as ct

    def kkt(P, q, A, b, sol):
        return max(np.linalg.norm(A @ sol.x + sol.s - b),
                   np.linalg.norm(P @ sol.x + q + A.T @ sol.z))

    for prefix, scale in (("quick", 0.25), ("row", 1.0)):
        for key, gen in rows(scale).items():
            P, q, A, b, cones = gen()
            sol = ct.Solver(P, q, A, b, cones, ct.Settings()).solve()
            dx = dobj = dit = 0.0
            worst = kkt(P, q, A, b, sol)
            for seed in JITTER_SEEDS:
                xi = np.random.default_rng(seed).standard_normal(q.shape)
                qj = q * (1 + 1e-15 * xi)
                j = ct.Solver(P, qj, A, b, cones, ct.Settings()).solve()
                dx = max(dx, float(np.abs(j.x - sol.x).max()
                                   / max(1.0, np.abs(sol.x).max())))
                dobj = max(dobj, abs(j.obj_val - sol.obj_val)
                           / max(1.0, abs(sol.obj_val)))
                dit = max(dit, abs(j.iterations - sol.iterations))
                worst = max(worst, kkt(P, qj, A, b, j))
            for k, v in (("dx", dx), ("dobj", dobj), ("dit", dit),
                         ("kkt", worst)):
                arrays[f"spread_{prefix}_{key}_{k}"] = np.asarray(v)
            print("spread", prefix, key, f"dx {dx:.3e} dobj {dobj:.3e} "
                  f"dit {dit} kkt {worst:.3e}", flush=True)


def batched_outputs(arrays):
    import clarabel_tpu as ct
    from benchmarks import configs
    from clarabel_tpu.parallel.batch_impl import BatchSolver

    for key, B in (("quick_batched_solved", 1024),
                   ("batched_solved", 4096)):
        (P, q, A, b), cones = configs.batched_socp(B=B, n=6)
        out = BatchSolver(cones, 6, ct.Settings()).solve(P, q, A, b)
        arrays[key] = np.asarray(int(np.sum(
            np.asarray(out.status) == int(ct.SolverStatus.SOLVED))))
        print(key, int(arrays[key]), flush=True)


SECTIONS = {"long": long_outputs, "rows": row_outputs,
            "spread": spread_outputs, "batched": batched_outputs, "modeling": modeling_outputs}


def main(argv=None):
    from clarabel_tpu import precompile

    wanted = list(argv if argv is not None else sys.argv[1:]) or \
        list(SECTIONS) + ["warmup"]
    npz = os.path.join(HERE, "long.npz")
    arrays = {}
    if set(wanted) != set(SECTIONS) | {"warmup"} and os.path.exists(npz):
        with np.load(npz) as f:
            arrays = {k: f[k] for k in f.files}
    for name in wanted:
        if name in SECTIONS:
            SECTIONS[name](arrays)
    np.savez(npz, **arrays)
    if "warmup" in wanted:
        statuses = precompile.warmup()
        with open(os.path.join(HERE, "long.json"), "w") as f:
            json.dump({"warmup": {k: v.name for k, v in statuses.items()}},
                      f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
