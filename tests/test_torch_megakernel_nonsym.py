"""The port's megakernel path on exponential and power cones (K1b's plain
PyTorch version, `BatchSolver(..., device="cpu")`) against the JAX
megakernel.

The JAX megakernel's nonsymmetric body compiles for minutes on the CPU, so
the comparison is against committed fixtures of its inputs and outputs
(`tests/torch_fixtures/make_nonsym_fixtures.py`): 64 lanes of the
exponential-cone batch of `bench.py`, 64 of the power-cone batch, and the
exponential batch again with `min_switch_step_length` raised to 0.9, where
lanes take the PrimalDual->Dual switch.

The bars are `_compare`'s of `tests/test_megakernel_nonsym.py`.  The
reference's f32-pair arithmetic ends marginal lanes ALMOST_SOLVED where
native float64 may solve them, so the SOLVED bar is one-sided: the port's
count at least the reference's less 2.  Every port status is SOLVED or
ALMOST_SOLVED; on the lanes both solve, objectives agree within 1e-6, x
within 5e-4 (flat optima) and iterations within 8 of the JAX megakernel's
or of the JAX loop's on the same lane (each fixture holds both: on lane 34
of the pow batch the f32-pair megakernel takes 43 iterations where the
JAX package's float64 loop, and the port, take 9); the port's SOLVED
lanes meet the true KKT conditions to 1e-7.
"""

import json
import os

import numpy as np
import pytest

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.interop import cone_from_tuple
from clarabel_tpu_torch.ipm import megakernel, megakernel_ref

from test_megakernel_nonsym import _exp_batch, _pow_batch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
SOLVED = int(ctt.SolverStatus.SOLVED)
ALMOST = int(ctt.SolverStatus.ALMOST_SOLVED)
MEGA = ctt.Settings(kkt_backend="megakernel")
EXP = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
POW = [ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)]


def load_fixture(name):
    f = np.load(os.path.join(FIXTURES, f"megakernel_{name}.npz"))
    cones = [cone_from_tuple(tuple(c)) for c in json.loads(str(f["cones"]))]
    over = json.loads(str(f["settings"]))
    ref = {k[4:]: f[k] for k in f.files if k.startswith("ref_")}
    ref["loop_iterations"] = f["loop_iterations"]
    return cones, int(f["n"]), over, f["P"], f["q"], f["A"], f["b"], ref


def assert_bars(out, ref, P, q, A, b):
    solved = out.status == SOLVED
    rsolved = ref["status"] == SOLVED
    assert np.isin(out.status, (SOLVED, ALMOST)).all(), out.status
    assert solved.sum() >= rsolved.sum() - 2, (out.status, ref["status"])
    both = np.nonzero(solved & rsolved)[0]
    assert len(both) > 0
    for i in both:
        assert abs(out.obj_val[i] - ref["obj_val"][i]) < 1e-6
        np.testing.assert_allclose(out.x[i], ref["x"][i], rtol=0, atol=5e-4)
        assert min(abs(int(out.iterations[i]) - int(r[i]))
                   for r in (ref["iterations"], ref["loop_iterations"])) <= 8
    for i in np.nonzero(solved)[0]:
        rp = np.linalg.norm(A[i] @ out.x[i] + out.s[i] - b[i])
        rd = np.linalg.norm(P[i] @ out.x[i] + q[i] + A[i].T @ out.z[i])
        assert rp < 1e-7 and rd < 1e-7, (i, rp, rd)
        assert abs(out.s[i] @ out.z[i]) < 1e-6


@pytest.mark.parametrize("name", ["exp", "pow", "switch"])
def test_matches_jax_megakernel_fixture(name):
    cones, n, over, P, q, A, b, ref = load_fixture(name)
    bs = ctt.BatchSolver(cones, n, MEGA.replace(**over), device="cpu")
    assert bs._mega_fn is not None
    out = bs.solve(P, q, A, b)
    assert_bars(out, ref, P, q, A, b)
    # the final scaling strategy of each lane (the kernel's third int row)
    spec = bs._mega_fn.spec
    _, flats = megakernel.prepare(P, q, A, b, spec, "cpu")
    _, ints = megakernel_ref.mega_solve_plain(*flats, spec, len(q))
    on_dual = int((ints[2] == megakernel_ref.DUAL).sum())
    if name == "switch":
        assert on_dual >= len(q) // 2
        assert ref["iterations"].mean() > 1.5 * load_fixture("exp")[-1][
            "iterations"].mean()
    else:
        assert on_dual <= 2


@pytest.mark.parametrize("cones", [EXP, POW], ids=["exp", "pow"])
@pytest.mark.parametrize("backend", ["megakernel", "condensed", "ldl"])
def test_batch_solver_now_solves_exp_and_pow(cones, backend):
    make = _exp_batch if isinstance(cones[1], ctt.ExponentialConeT) \
        else _pow_batch
    P, q, A, b, _, n = make(8)
    bs = ctt.BatchSolver(cones, n, ctt.Settings(kkt_backend=backend),
                         device="cpu")
    assert (bs._mega_fn is not None) == (backend == "megakernel")
    sol = bs.solve(P, q, A, b)
    assert (sol.status == SOLVED).sum() >= 7, sol.status
    assert np.isfinite(sol.x).all()


@pytest.mark.parametrize("cone", [
    ctt.GenPowerConeT((0.4, 0.6), 1), ctt.PSDTriangleConeT(2)],
    ids=["genpow", "psd"])
def test_genpow_and_psd_now_solve(cone):
    """Beside an exponential cone: the megakernel's plain version (the
    nonsymmetric unit start with a PSD or genpow segment) and the loop
    agree."""
    P, q, A, b, _, n = _exp_batch(8)
    w = 3
    rng = np.random.default_rng(w)
    # the extra cone's rows: a point within 0.1 of its center, times 10
    center = (np.array([1.0, 0.0, 1.0]) if isinstance(cone, ctt.PSDTriangleConeT)
              else np.array([1.0, 1.0, 0.0]))
    A = np.concatenate([A, -10.0 * np.broadcast_to(np.eye(w), (8, w, w))
                        + 0.1 * rng.standard_normal((8, w, n))], 1)
    b = np.concatenate([b, np.broadcast_to(10.0 * center, (8, w))], 1)
    cones = EXP + [cone]
    sols = [ctt.BatchSolver(cones, n, st, device="cpu").solve(P, q, A, b)
            for st in (MEGA, ctt.Settings(kkt_backend="condensed"))]
    for sol in sols:
        assert (sol.status == SOLVED).sum() >= 7, sol.status
    both = (sols[0].status == SOLVED) & (sols[1].status == SOLVED)
    np.testing.assert_allclose(sols[0].obj_val[both], sols[1].obj_val[both],
                               rtol=0, atol=1e-6)


def test_exp_rescue_closes_marginal_lanes():
    """The counterpart of tests/test_megakernel_nonsym.py
    test_exp_rescue_closes_marginal_lanes."""
    P, q, A, b, _, n = _exp_batch(8, seed=7)
    bs = ctt.BatchSolver(EXP, n, MEGA, rescue="same",
                         rescue_settings=ctt.Settings(), device="cpu")
    assert bs.solve(P, q, A, b).all_solved
