"""The port's batched loop solver on exponential and power cones against
the JAX package's loop (`jax.vmap` of `clarabel_tpu/ipm/loop.py`).

The 8-lane batches are those of `tests/test_megakernel_nonsym.py`
(`_exp_batch`, `_pow_batch`); the switch case is the exponential batch
with `min_switch_step_length` raised to 0.9, where every lane takes the
PrimalDual->Dual switch.  One case (exp, ldl) is compared live: the JAX
loop compiles for about 15 s.  Every case, that one included, is compared
against `tests/torch_fixtures/loop_nonsym.npz`
(`make_nonsym_fixtures.py loop`).

The bars are `_compare`'s of `tests/test_megakernel_nonsym.py`: the
port's SOLVED count at least the reference's less 2, every port status
SOLVED or ALMOST_SOLVED; on the lanes both solve, objectives within 1e-6,
x within 5e-4 (the instances have flat optima) and iterations within 8;
the true KKT residuals of the port's SOLVED lanes below 1e-7.
"""

import os

import numpy as np
import pytest

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.ipm.loop import DUAL

from test_megakernel_nonsym import _exp_batch, _pow_batch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_fixtures", "loop_nonsym.npz")
SOLVED = int(ct.SolverStatus.SOLVED)
ALMOST = int(ct.SolverStatus.ALMOST_SOLVED)
SWITCH = 0.9
CASES = [("exp", "condensed"), ("exp", "ldl"), ("pow", "ldl"),
         ("pow", "condensed"), ("switch", "ldl"), ("switch", "condensed")]


def case(name):
    """(P, q, A, b, port cones, n, settings overrides) of a case."""
    if name == "pow":
        P, q, A, b, _, n = _pow_batch(8)
        cones = [ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)]
    else:
        P, q, A, b, _, n = _exp_batch(8)
        cones = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
    over = {"min_switch_step_length": SWITCH} if name == "switch" else {}
    return P, q, A, b, cones, n, over


def port_solve(name, backend):
    P, q, A, b, cones, n, over = case(name)
    bs = ctt.BatchSolver(cones, n, ctt.Settings(kkt_backend=backend, **over),
                         device="cpu")
    return bs.solve(P, q, A, b)


def assert_bars(out, ref, P, q, A, b):
    """`out` a port BatchSolution; `ref` the reference's arrays."""
    solved = out.status == SOLVED
    rsolved = ref["status"] == SOLVED
    assert np.isin(out.status, (SOLVED, ALMOST)).all(), out.status
    assert solved.sum() >= rsolved.sum() - 2, (out.status, ref["status"])
    both = np.nonzero(solved & rsolved)[0]
    assert len(both) > 0
    for i in both:
        assert abs(out.obj_val[i] - ref["obj_val"][i]) < 1e-6
        np.testing.assert_allclose(out.x[i], ref["x"][i], rtol=0, atol=5e-4)
        assert abs(int(out.iterations[i]) - int(ref["iterations"][i])) <= 8
    for i in np.nonzero(solved)[0]:
        rp = np.linalg.norm(A[i] @ out.x[i] + out.s[i] - b[i])
        rd = np.linalg.norm(P[i] @ out.x[i] + q[i] + A[i].T @ out.z[i])
        assert rp < 1e-7 and rd < 1e-7, (i, rp, rd)
        assert abs(out.s[i] @ out.z[i]) < 1e-6


def test_exp_ldl_matches_jax_loop_live():
    P, q, A, b, _, n = _exp_batch(8)
    cones = [ct.NonnegativeConeT(2), ct.ExponentialConeT()]
    ref = ct.BatchSolver(cones, n, ct.Settings(kkt_backend="ldl")).solve(
        P, q, A, b)
    ref = {k: np.asarray(getattr(ref, k))
           for k in ("x", "status", "obj_val", "iterations")}
    assert_bars(port_solve("exp", "ldl"), ref, P, q, A, b)
    # the live run is what the fixture holds
    f = np.load(FIXTURE)
    np.testing.assert_array_equal(ref["status"], f["exp_ldl_status"])
    np.testing.assert_allclose(ref["x"], f["exp_ldl_x"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,backend", CASES)
def test_matches_jax_loop_fixture(name, backend):
    P, q, A, b, *_ = case(name)
    f = np.load(FIXTURE)
    ref = {k: f[f"{name}_{backend}_{k}"]
           for k in ("x", "status", "obj_val", "iterations")}
    out = port_solve(name, backend)
    assert_bars(out, ref, P, q, A, b)
    strat = out._out["scaling"]
    if name == "switch":
        # the downgrade is taken (and the reference takes as many
        # iterations: about twice those of the exp case)
        assert (strat == DUAL).sum() >= 6
        assert ref["iterations"].mean() > 1.5 * f[
            f"exp_{backend}_iterations"].mean()
    else:
        assert (strat == DUAL).sum() <= 2


def test_nonsymmetric_layouts_keep_the_diag_order_off():
    """The dense ldl's descending-|diag| order stays off where an exp or
    pow Hs block enters the KKT (clarabel_tpu/ipm/loop.py:260-271)."""
    from clarabel_tpu_torch.cones.layout import ConeLayout
    from clarabel_tpu_torch.ipm import loop

    seen = []
    real = loop.kkt.assemble_and_factor

    def spy(P, A, Hs, signs, settings, factor_dtype=None):
        seen.append(settings.dense_ldl_diag_order)
        return real(P, A, Hs, signs, settings, factor_dtype)

    P, q, A, b, cones, n, _ = case("exp")
    loop.kkt.assemble_and_factor = spy
    try:
        solve = loop.build_solve(ConeLayout(cones), ctt.Settings(), n, True,
                                 kkt_backend="ldl")
        import torch
        solve(*(torch.from_numpy(a[:2]) for a in (P, q, A, b)))
    finally:
        loop.kkt.assemble_and_factor = real
    assert seen and not any(seen)
