"""The port's batched loop solver on generalized power cones against the
JAX package's loop (`jax.vmap` of `clarabel_tpu/ipm/loop.py`, through its
`BatchSolver`).

The batch is that of `tests/test_megakernel_nonsym.py`
(`test_genpow_matches_loop`): n=4, cones [NN(2), GenPow((0.3, 0.7), 2)],
16 lanes.  Backends ldl and condensed; the ldl case is compared live
(the JAX loop compiles for about 15 s), both against the committed
fixture `tests/torch_fixtures/loop_psd_genpow.npz`.  A generalized power
cone has only the dual scaling, so every lane runs on the Dual strategy
from its first iteration (clarabel_tpu/ipm/loop.py:213-215, 272).

Bars as `tests/test_torch_loop_psd.py`: every port status SOLVED or
ALMOST_SOLVED and its SOLVED count at least the reference's less 2; on
the lanes both solve, objectives within 1e-6 (1 + |obj|) and iterations
within 8; the port's SOLVED lanes meet the true KKT conditions to 1e-7.
"""

import numpy as np
import pytest
import torch

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.interop import cone_from_tuple
from clarabel_tpu_torch.ipm import loop

from test_torch_loop_psd import assert_bars, fixture, fx, port_solve


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_genpow_ldl_matches_jax_loop_live():
    cones, n, P, q, A, b = fx.case_inputs("genpow", fx.LOOP_B)
    ref = ct.BatchSolver([getattr(ct, c)(*a) for c, *a in cones], n,
                         ct.Settings(kkt_backend="ldl")).solve(P, q, A, b)
    ref = {k: np.asarray(getattr(ref, k))
           for k in ("x", "status", "obj_val", "iterations")}
    out, data = port_solve("genpow", "ldl")
    assert_bars(out, ref, *data)
    f = fixture("genpow", "ldl")
    np.testing.assert_array_equal(ref["status"], f["status"])
    np.testing.assert_allclose(ref["x"], f["x"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", fx.BACKENDS)
def test_matches_jax_loop_fixture(backend):
    out, data = port_solve("genpow", backend)
    assert_bars(out, fixture("genpow", backend), *data)
    assert (out._out["scaling"] == loop.DUAL).all()


@pytest.mark.parametrize("backend", fx.BACKENDS)
def test_every_lane_starts_on_dual(backend):
    """With max_iter=0 the loop stops at its first check: the strategy it
    returns is the one every lane starts with."""
    cones, n, P, q, A, b = fx.case_inputs("genpow", 4)
    layout = ConeLayout([cone_from_tuple(tuple(c)) for c in cones])
    solve = loop.build_solve(layout, ctt.Settings(max_iter=0), n, True,
                             kkt_backend=backend)
    out = solve(*(torch.from_numpy(a) for a in (P, q, A, b)))
    assert (out["iterations"] == 0).all()
    assert (out["scaling"] == loop.DUAL).all()
