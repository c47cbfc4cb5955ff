"""Parity of the port's batched megakernel path with the JAX megakernel.

The port runs here as the kernel's plain PyTorch version
(`BatchSolver(..., device="cpu")`).  The JAX megakernel runs on the CPU
as `tests/test_megakernel.py` runs it, through an ahead-of-time compile
that costs about a minute at n=2 and about seven at the bench shape.  So
the live comparison is at n=2 only (one module-scoped JAX solver), and
the LP batch, the zero-cone batch and the bench shape (n=6, m=13, B=64)
are held against committed fixtures of the JAX megakernel's inputs and
outputs (`tests/torch_fixtures/make_megakernel_fixtures.py`).

The bars are the repository's own (`tests/test_megakernel.py:73-95`):
the port's SOLVED count is at least the reference's less 1; on lanes both
solve, x and the objective agree within 1e-6 and iterations within 4; the
port's true-KKT residuals are below 1e-7.
"""

import dataclasses
import importlib.util
import json
import os
import types

import numpy as np
import pytest

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.interop import cone_to_tuple, from_reference

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
SOLVED = int(ct.SolverStatus.SOLVED)

N, M = 2, 4
CONES = [ct.NonnegativeConeT(2), ct.SecondOrderConeT(2)]


def _batch(B, seed=0, infeasible_lanes=()):
    """The batch of tests/test_megakernel.py, draw for draw."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, N, N))
    P = np.einsum("bij,bkj->bik", F, F) + np.eye(N)
    q = rng.standard_normal((B, N))
    A = np.tile(np.vstack([np.eye(N), [[1.0, 0.3], [0.2, 1.0]]]),
                (B, 1, 1))
    b = np.abs(rng.standard_normal((B, M))) + 1.0
    for i in infeasible_lanes:
        A[i, 0] = [1.0, 0.0]
        A[i, 1] = [-1.0, 0.0]
        b[i, 0] = -1.0
        b[i, 1] = -1.0
    return P, q, A, b


def port_solver(ref_settings, ref_cones, n, p_nonzero=True):
    """The port's BatchSolver configured from the reference's objects."""
    st, cones = from_reference(dataclasses.asdict(ref_settings),
                               [cone_to_tuple(c) for c in ref_cones])
    return ctt.BatchSolver(cones, n, st, p_nonzero=p_nonzero, device="cpu")


def certificate_radius(P, gap):
    """sqrt(2 gap / lambda_min(P)): how far x may sit from the optimum of
    a strongly convex QP whose solution has duality gap `gap`."""
    lam = np.linalg.eigvalsh(P)[:, 0]
    return np.sqrt(2.0 * np.abs(gap) / lam)


def assert_parity(out, ref, P, q, A, b, x_radius=None):
    """`out` and `ref` hold x/status/obj_val/iterations arrays (`out`
    also s and z).  `x_radius` (per lane), where given, is the distance
    the 1e-8 termination leaves x undetermined by; x then agrees within
    1e-6 or within that radius."""
    out = types.SimpleNamespace(**out)
    solved = out.status == SOLVED
    rsolved = ref["status"] == SOLVED
    assert solved.sum() >= rsolved.sum() - 1, (out.status, ref["status"])
    both = np.nonzero(solved & rsolved)[0]
    assert len(both) > 0
    for i in both:
        assert abs(out.obj_val[i] - ref["obj_val"][i]) < 1e-6
        tol = 1e-6 if x_radius is None else max(1e-6, x_radius[i])
        np.testing.assert_allclose(out.x[i], ref["x"][i], rtol=0, atol=tol)
        assert abs(int(out.iterations[i]) - int(ref["iterations"][i])) <= 4
    for i in np.nonzero(solved)[0]:
        rp = np.linalg.norm(A[i] @ out.x[i] + out.s[i] - b[i])
        rd = np.linalg.norm(P[i] @ out.x[i] + q[i] + A[i].T @ out.z[i])
        assert rp < 1e-7 and rd < 1e-7, (i, rp, rd)
        assert abs(out.s[i] @ out.z[i]) < 1e-6


def arrays(sol):
    return {k: getattr(sol, k)
            for k in ("x", "status", "obj_val", "iterations", "s", "z")}


def _slice(d, sl):
    return {k: v[sl] for k, v in d.items()}


@pytest.fixture(scope="module")
def live():
    """Both live batches, the one of tests/test_megakernel.py (lanes 0-7)
    and the one with an infeasible lane (lanes 8-15), stacked so that the
    JAX megakernel compiles once; the port solves the same 16 lanes.
    Lanes are independent in both, so each batch's lanes come out as if
    solved alone."""
    parts = [_batch(8), _batch(8, seed=2, infeasible_lanes=(3,))]
    P, q, A, b = (np.concatenate(a) for a in zip(*parts))
    st = ct.Settings(kkt_backend="megakernel")
    ref = ct.BatchSolver(CONES, N, st).solve(P, q, A, b)
    out = port_solver(st, CONES, N).solve(P, q, A, b)
    return (P, q, A, b), arrays(out), arrays(ref)


def test_matches_jax_megakernel_live(live):
    data, out, ref = live
    sl = slice(0, 8)
    out, ref = _slice(out, sl), _slice(ref, sl)
    assert_parity(out, ref, *(a[sl] for a in data))
    np.testing.assert_array_equal(out["status"], ref["status"])


def test_infeasible_lane_matches_jax_megakernel_live(live):
    data, out, ref = live
    sl = slice(8, 16)
    out, ref = _slice(out, sl), _slice(ref, sl)
    P, q, A, b = (a[sl] for a in data)
    inf = (int(ct.SolverStatus.PRIMAL_INFEASIBLE),
           int(ct.SolverStatus.ALMOST_PRIMAL_INFEASIBLE))
    assert out["status"][3] in inf and ref["status"][3] in inf
    assert np.isnan(out["obj_val"][3])
    ok = np.isin(out["status"], (SOLVED, int(ct.SolverStatus.ALMOST_SOLVED)))
    ok[3] = True
    assert ok.all()
    keep = np.arange(8) != 3
    assert_parity(_slice(out, keep), _slice(ref, keep),
                  P[keep], q[keep], A[keep], b[keep])


def load_fixture(name):
    f = np.load(os.path.join(FIXTURES, f"megakernel_{name}.npz"))
    cones = [tuple(c) for c in json.loads(str(f["cones"]))]
    ref = {k[4:]: f[k] for k in f.files if k.startswith("ref_")}
    return (cones, int(f["n"]), bool(f["p_nonzero"]),
            f["P"], f["q"], f["A"], f["b"], ref)


@pytest.mark.parametrize("name", ["lp", "zero", "bench"])
def test_matches_jax_megakernel_fixture(name):
    cones, n, pn, P, q, A, b, ref = load_fixture(name)
    ref_cones = [getattr(ct, c)(*args) for c, *args in cones]
    bs = port_solver(ct.Settings(kkt_backend="megakernel"), ref_cones, n,
                     p_nonzero=pn)
    out = bs.solve(P if pn else None, q, A, b)
    x_radius = None
    if name == "bench":
        # at n=6 the 1e-8 termination pins x only to ~1e-4 on some lanes:
        # the JAX package's own condensed loop and megakernel differ by
        # up to 1.2e-5 on this batch (DEVIATIONS.md); hold x to the
        # optimality certificate of both solutions there
        gap_port = out.obj_val - out._out["obj_val_dual"]
        gap_ref = ref["obj_val"] - ref["obj_val_dual"]
        x_radius = (certificate_radius(P, gap_port)
                    + certificate_radius(P, gap_ref))
    assert_parity(arrays(out), ref, P, q, A, b, x_radius=x_radius)
    np.testing.assert_array_equal(out.status, ref["status"])
    if name == "zero":
        # the equality row holds and its slack is 0
        eq = np.einsum("bj,bj->b", A[:, 0], out.x) - b[:, 0]
        assert np.abs(eq).max() < 1e-8
        assert np.abs(out.s[:, 0]).max() < 1e-10


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_megakernel_fixtures",
        os.path.join(FIXTURES, "make_megakernel_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("name", ["lp", "zero", "bench"])
def test_fixtures_regenerate(name):
    """The committed fixtures are what the JAX megakernel computes now
    (the bench shape alone compiles for about seven minutes)."""
    fresh = _fixture_script().run_reference(name)
    f = np.load(os.path.join(FIXTURES, f"megakernel_{name}.npz"))
    assert sorted(fresh) == sorted(f.files)
    for k in f.files:
        if f[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], f[k], rtol=1e-10,
                                       atol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(fresh[k], f[k])
