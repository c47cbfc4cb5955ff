"""Three settings the port used to refuse, against the reference's outputs
in `tests/torch_fixtures/faults.npz` (made by `make_fault_fixtures.py`):

* the dense ldl loop on lanes with N = n + m > 512 (the blocked factor);
* `Settings(verbose=True)`: the iteration rows of the batched loop;
* (in tests/test_torch_batch.py) `kkt_backend="blockarrow"` and
  `"multifrontal"` in `BatchSolver`, which passes no structure plan, so
  they run the dense ldl loop there (the single-instance `Solver` analyzes
  the pattern for its plan: tests/test_torch_structured_solver.py).

Bars: statuses equal, x and the objective within 1e-6 and iterations
within 4 on the N = 520 lanes (strongly convex QPs: x is unique); the
verbose rows in the reference's format, one per lane and pass, with the
reference's iteration column and its costs to the printed digits.
"""

import os
import re

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.linalg import ldl

FIX = np.load(os.path.join(os.path.dirname(__file__), "torch_fixtures",
                           "faults.npz"))
ROW = re.compile(r"^ {0,3}\d{1,4}(  [ -]\d\.\d{4}e[+-]\d\d){2}"
                 r"(  \d\.\d\de[+-]\d\d){6}$")


def test_loop_solves_lanes_above_512_with_the_blocked_factor():
    P, q, A, b = bench_data.make_large_qp_eq(3)
    cones = [ctt.ZeroConeT(20), ctt.NonnegativeConeT(300)]
    bs = ctt.BatchSolver(cones, 200, device="cpu")
    assert bs._mega_fn is None and bs.n + bs.m == 520
    sol = bs.solve(P, q, A, b)
    np.testing.assert_array_equal(sol.status, FIX["blocked_status"])
    assert np.abs(sol.x - FIX["blocked_x"]).max() < 1e-6
    assert np.abs(sol.obj_val - FIX["blocked_obj_val"]).max() < 1e-6
    assert np.abs(sol.iterations - FIX["blocked_iterations"]).max() <= 4


@pytest.mark.parametrize("N,block", [(16, 8), (24, 8)])
def test_blocked_factor_matches_the_unblocked_one(N, block):
    """Same L and d as `ldl_factor` up to summation order, with the
    dynamic regularization tripped on one pivot of one lane."""
    rng = np.random.default_rng(N)
    n = N // 2
    M = rng.standard_normal((3, N, N))
    K = M @ M.transpose(0, 2, 1) / N
    K[:, n:, n:] = -K[:, n:, n:] - np.eye(N - n)
    K[1, 3, :] = K[1, :, 3] = 0.0
    K[1, 3, 3] = 1e-15
    signs = torch.tensor(np.r_[np.ones(n), -np.ones(N - n)])
    Kt = torch.tensor(K)
    L, d, ok = ldl.ldl_factor(Kt, signs)
    Lb, db, okb = ldl.ldl_factor_blocked(Kt, signs, block=block)
    assert ok.all() and okb.all()
    assert float(d[1, 3]) == 2e-7
    torch.testing.assert_close(Lb, L, rtol=0, atol=1e-10)
    torch.testing.assert_close(db, d, rtol=1e-12, atol=1e-12)


def test_verbose_prints_the_reference_rows(capsys):
    data = bench_data.make_batch(3, 3, 0)
    cones = [ctt.NonnegativeConeT(3), ctt.SecondOrderConeT(4)]
    sol = ctt.BatchSolver(cones, 3, ctt.Settings(verbose=True),
                          device="cpu").solve(*data)
    rows = [r for r in capsys.readouterr().out.splitlines() if r.strip()]
    ref = [str(r) for r in FIX["verbose_rows"]]
    assert all(ROW.match(r) for r in rows), rows[:3]
    # one row per lane on every pass: passes = the most iterations + 1
    np.testing.assert_array_equal(sol.iterations, FIX["verbose_iterations"])
    assert len(rows) == 3 * (sol.iterations.max() + 1) == len(ref)
    cols = np.array([[float(v) for v in r.split()] for r in rows])
    rcols = np.array([[float(v) for v in r.split()] for r in ref])
    np.testing.assert_array_equal(cols[:, 0], rcols[:, 0])
    np.testing.assert_allclose(cols[:, 1:3], rcols[:, 1:3], rtol=1e-4,
                               atol=1e-8)


def test_verbose_off_prints_nothing(capsys):
    cones = [ctt.NonnegativeConeT(3), ctt.SecondOrderConeT(4)]
    ctt.BatchSolver(cones, 3, device="cpu").solve(
        *bench_data.make_batch(3, 3, 0))
    assert capsys.readouterr().out == ""
