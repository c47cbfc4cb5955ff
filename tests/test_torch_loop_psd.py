"""The port's batched loop solver on PSD-triangle cones against the JAX
package's loop (`jax.vmap` of `clarabel_tpu/ipm/loop.py`, through its
`BatchSolver`).

Batches (16 lanes, `tests/torch_fixtures/make_psd_genpow_fixtures.py`):
the small SDPs of `tests/test_megakernel_psd.py` at sides 2 and 3, its
equality-constrained variant (a zero cone beside the PSD cone), and a
layout with five PSD sides, which the layout buckets (the cones of
`tests/test_psd_bucketing.py`).  Backends ldl and condensed.  One case
(psd2, ldl) is compared live: the JAX loop compiles for about 15 s.  Every
case, that one included, is compared against the committed fixture
`loop_psd_genpow.npz`.

The bars are those the JAX package holds its own backends to
(`tests/test_megakernel_psd.py`): every port status SOLVED or
ALMOST_SOLVED and its SOLVED count at least the reference's less 2; on
the lanes both solve, objectives within 1e-6 (1 + |obj|) and iterations
within 8; the port's SOLVED lanes meet the true KKT conditions to 1e-7
and every PSD slack has its least eigenvalue above -1e-8.
"""

import os
import sys

import numpy as np
import pytest
import torch

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.interop import cone_from_tuple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))
import make_psd_genpow_fixtures as fx  # noqa: E402

FIXTURE = os.path.join(HERE, "torch_fixtures", "loop_psd_genpow.npz")
SOLVED = int(ct.SolverStatus.SOLVED)
ALMOST = int(ct.SolverStatus.ALMOST_SOLVED)
PSD_CASES = ("psd2", "psd3", "psd_zero", "bucketed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small batched ops: one thread each, as the suite runs workers side
    by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def psd_min_eigs(cones, s):
    """(B,) least eigenvalue over the PSD blocks of the slacks s (B, m)."""
    out = np.full(s.shape[0], np.inf)
    lo = 0
    for name, *args in cones:
        d = args[0] if name != "GenPowerConeT" else len(args[0]) + args[1]
        if name == "PSDTriangleConeT":
            k = d
            d = k * (k + 1) // 2
            M = np.zeros((s.shape[0], k, k))
            p = lo
            for c in range(k):
                for r in range(c + 1):
                    v = s[:, p] / (1.0 if r == c else np.sqrt(2.0))
                    M[:, r, c] = M[:, c, r] = v
                    p += 1
            out = np.minimum(out, np.linalg.eigvalsh(M)[:, 0])
        elif name == "ExponentialConeT" or name == "PowerConeT":
            d = 3
        lo += d
    return out


def assert_bars(out, ref, cones, P, q, A, b):
    """`out` a port BatchSolution; `ref` the reference's arrays."""
    solved = out.status == SOLVED
    rsolved = ref["status"] == SOLVED
    assert np.isin(out.status, (SOLVED, ALMOST)).all(), out.status
    assert solved.sum() >= rsolved.sum() - 2, (out.status, ref["status"])
    both = np.nonzero(solved & rsolved)[0]
    assert len(both) > 0
    for i in both:
        assert abs(out.obj_val[i] - ref["obj_val"][i]) < 1e-6 * (
            1 + abs(ref["obj_val"][i])), i
        assert abs(int(out.iterations[i]) - int(ref["iterations"][i])) <= 8
    s = out.s
    eigs = psd_min_eigs(cones, s)
    for i in np.nonzero(solved)[0]:
        rp = np.linalg.norm(A[i] @ out.x[i] + s[i] - b[i])
        rd = np.linalg.norm(P[i] @ out.x[i] + q[i] + A[i].T @ out.z[i])
        assert rp < 1e-7 and rd < 1e-7, (i, rp, rd)
        assert eigs[i] > -1e-8, (i, eigs[i])


def port_solve(case, backend, B=fx.LOOP_B):
    cones, n, P, q, A, b = fx.case_inputs(case, B)
    bs = ctt.BatchSolver([cone_from_tuple(tuple(c)) for c in cones], n,
                         ctt.Settings(kkt_backend=backend), device="cpu")
    return bs.solve(P, q, A, b), (cones, P, q, A, b)


def fixture(case, backend):
    f = np.load(FIXTURE)
    return {k: f[f"{case}_{backend}_{k}"]
            for k in ("x", "status", "obj_val", "iterations")}


def test_psd2_ldl_matches_jax_loop_live():
    cones, n, P, q, A, b = fx.case_inputs("psd2", fx.LOOP_B)
    ref = ct.BatchSolver([getattr(ct, c)(*a) for c, *a in cones], n,
                         ct.Settings(kkt_backend="ldl")).solve(P, q, A, b)
    ref = {k: np.asarray(getattr(ref, k))
           for k in ("x", "status", "obj_val", "iterations")}
    out, data = port_solve("psd2", "ldl")
    assert_bars(out, ref, *data)
    # the live run is what the fixture holds
    f = fixture("psd2", "ldl")
    np.testing.assert_array_equal(ref["status"], f["status"])
    np.testing.assert_allclose(ref["x"], f["x"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", fx.BACKENDS)
@pytest.mark.parametrize("case", PSD_CASES)
def test_matches_jax_loop_fixture(case, backend):
    out, data = port_solve(case, backend)
    assert_bars(out, fixture(case, backend), *data)


def test_psd_layouts_keep_the_diag_order_off_and_stay_symmetric():
    """The dense ldl's descending-|diag| order stays off where a PSD Hs
    block enters the KKT (clarabel_tpu/ipm/loop.py:260-271), and a PSD
    layout runs the symmetric IPM: the PrimalDual strategy throughout."""
    from clarabel_tpu_torch.cones.layout import ConeLayout
    from clarabel_tpu_torch.ipm import loop

    seen = []
    real = loop.kkt.assemble_and_factor

    def spy(P, A, Hs, signs, settings, factor_dtype=None):
        seen.append(settings.dense_ldl_diag_order)
        return real(P, A, Hs, signs, settings, factor_dtype)

    cones, n, P, q, A, b = fx.case_inputs("psd_zero", 2)
    layout = ConeLayout([cone_from_tuple(tuple(c)) for c in cones])
    assert layout.is_symmetric
    loop.kkt.assemble_and_factor = spy
    try:
        solve = loop.build_solve(layout, ctt.Settings(), n, True,
                                 kkt_backend="ldl")
        out = solve(*(torch.from_numpy(a) for a in (P, q, A, b)))
    finally:
        loop.kkt.assemble_and_factor = real
    assert seen and not any(seen)
    assert (out["scaling"] == loop.PRIMAL_DUAL).all()
