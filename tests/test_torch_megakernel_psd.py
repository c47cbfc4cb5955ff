"""The port's megakernel path on PSD-triangle cones (K1d's plain PyTorch
version, `BatchSolver(..., kkt_backend="megakernel", device="cpu")`)
against the JAX package.

The JAX megakernel's PSD body compiles for minutes on the CPU (side 3 for
more than 25, tests/test_megakernel_psd.py:61-72), so the comparison is
against committed fixtures (`tests/torch_fixtures/make_psd_genpow_fixtures.py`):
the JAX megakernel on 64 lanes of the side-2 SDP batch and of its
equality-constrained variant, each file with the JAX loop's solve beside
it, and side 3 against the JAX loop's fixture (16 lanes, both backends).

The bars are those of `tests/test_megakernel_psd.py:80-100`: every port
status SOLVED or ALMOST_SOLVED and its SOLVED count at least the
reference's less 2; on the lanes both solve, objectives within
1e-6 (1 + |obj|) and iterations within 8 of the JAX megakernel's or of
the JAX loop's on the same lane; the port's SOLVED lanes meet the true
KKT conditions to 1e-7, and every PSD slack has its least eigenvalue
above -1e-8.
"""

import json
import os

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.interop import cone_from_tuple
from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref
from clarabel_tpu_torch.parallel import batch_impl

from test_torch_loop_psd import fixture as loop_fixture, fx, psd_min_eigs

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
SOLVED = int(ctt.SolverStatus.SOLVED)
ALMOST = int(ctt.SolverStatus.ALMOST_SOLVED)
MEGA = ctt.Settings(kkt_backend="megakernel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_fixture(name):
    f = np.load(os.path.join(FIXTURES, f"megakernel_{name}.npz"))
    cones = json.loads(str(f["cones"]))
    ref = {k[4:]: f[k] for k in f.files if k.startswith("ref_")}
    ref["loop_iterations"] = f["loop_iterations"]
    return cones, int(f["n"]), f["P"], f["q"], f["A"], f["b"], ref


def assert_bars(out, ref, cones, P, q, A, b, iteration_refs):
    solved = out.status == SOLVED
    rsolved = ref["status"] == SOLVED
    assert np.isin(out.status, (SOLVED, ALMOST)).all(), out.status
    assert solved.sum() >= rsolved.sum() - 2, (out.status, ref["status"])
    both = np.nonzero(solved & rsolved)[0]
    assert len(both) > 0
    for i in both:
        assert abs(out.obj_val[i] - ref["obj_val"][i]) < 1e-6 * (
            1 + abs(ref["obj_val"][i])), i
        assert min(abs(int(out.iterations[i]) - int(r[i]))
                   for r in iteration_refs) <= 8
    eigs = psd_min_eigs(cones, out.s)
    for i in np.nonzero(solved)[0]:
        rp = np.linalg.norm(A[i] @ out.x[i] + out.s[i] - b[i])
        rd = np.linalg.norm(P[i] @ out.x[i] + q[i] + A[i].T @ out.z[i])
        assert rp < 1e-7 and rd < 1e-7, (i, rp, rd)
        assert eigs[i] > -1e-8, (i, eigs[i])


def port_solver(cones, n, st=MEGA, **kw):
    return ctt.BatchSolver([cone_from_tuple(tuple(c)) for c in cones], n,
                           st, device="cpu", **kw)


@pytest.mark.parametrize("name", ["psd2", "psd_zero"])
def test_matches_jax_megakernel_fixture(name):
    cones, n, P, q, A, b, ref = load_fixture(name)
    bs = port_solver(cones, n)
    assert bs._mega_fn is not None
    out = bs.solve(P, q, A, b)
    assert_bars(out, ref, cones, P, q, A, b,
                (ref["iterations"], ref["loop_iterations"]))
    # PSD is symmetric: every lane stays on PrimalDual
    spec = bs._mega_fn.spec
    _, flats = megakernel.prepare(P, q, A, b, spec, "cpu")
    _, ints = megakernel_ref.mega_solve_plain(*flats, spec, len(q))
    assert (ints[2] == megakernel_ref.PRIMAL_DUAL).all()


@pytest.mark.parametrize("backend", fx.BACKENDS)
def test_side3_matches_jax_loop_fixture(backend):
    """Side 3 against the JAX loop (its megakernel does not compile on the
    CPU in reasonable time)."""
    cones, n, P, q, A, b = fx.case_inputs("psd3", fx.LOOP_B)
    ref = loop_fixture("psd3", backend)
    out = port_solver(cones, n).solve(P, q, A, b)
    assert_bars(out, ref, cones, P, q, A, b, (ref["iterations"],))


def test_eligibility_and_auto_resolution():
    """Sides up to 3 are the megakernel's, charged against the budget of
    nonsymmetric segments (clarabel_tpu/ipm/megakernel.py:128-184); a
    larger side resolves "auto" to a loop backend, on a card too."""
    st = ctt.Settings()
    cuda = torch.device("cuda")
    for cones, n, ok in (
            ([ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3, True),
            ([ctt.ZeroConeT(1), ctt.PSDTriangleConeT(2)], 3, True),
            ([ctt.PSDTriangleConeT(4)], 3, False),
            ([ctt.PSDTriangleConeT(3)] * 6, 4, False),    # budget: 6 x 4
            ([ctt.PSDTriangleConeT(2)] * 8, 4, True)):    # budget: 8 x 2
        lay = ConeLayout(cones)
        assert megakernel.eligible(lay, st, n) == ok
        want = "megakernel" if ok else (
            "ldl" if any(g.kind == "zero" for g in lay.groups.values())
            else "condensed")
        assert batch_impl.resolve_backend(lay, st, n, cuda) == want
    with pytest.raises(ValueError, match="megakernel"):
        ctt.BatchSolver([ctt.PSDTriangleConeT(4)], 3, MEGA, device="cpu")


def test_spec_and_kernel_params():
    cones, n, *_ = load_fixture("psd_zero")
    spec = port_solver(cones, n)._mega_fn.spec
    assert _cuda.shape_of(spec) == (3, 9, 3, 0, 1, 0, 0)
    prm = _cuda._params(spec)
    assert list(prm.seg_kind) == [0, 1, 6]
    assert list(prm.seg_hi) == [1, 6, 9]
    assert not hasattr(prm, "gp_alpha")
    path = _cuda.megakernel.lib_path(_cuda.shape_of(spec))
    assert "n3_m9_s3_ns0_psd1_gp0" in path


def test_rescue_closes_lanes_the_kernel_leaves():
    """A cut iteration limit leaves lanes to the rescue cascade, which
    closes them with the loop."""
    P, q, A, b = bench_data.make_sdp_batch(8, 3, seed=13)
    cones = [("NonnegativeConeT", 6), ("PSDTriangleConeT", 3)]
    cut = MEGA.replace(max_iter=5)
    alone = port_solver(cones, 3, cut).solve(P, q, A, b)
    assert (alone.status != SOLVED).sum() >= 4
    res = port_solver(cones, 3, cut, rescue="cpu",
                      rescue_settings=ctt.Settings()).solve(P, q, A, b)
    assert res.all_solved
    kept = alone.status == SOLVED
    np.testing.assert_array_equal(res.x[kept], alone.x[kept])


def _lol(A):
    T = torch.from_numpy(A)
    return [[T[:, i, j] for j in range(A.shape[2])] for i in range(A.shape[1])]


@pytest.mark.parametrize("side", [2, 3])
def test_jacobi_sweeps_reach_float64_rounding(side):
    """The sweep rule of K1d (DEVIATIONS.md #12): the one-sided Jacobi SVD
    and the eigenvalue Jacobi stop once no pair rotates, within a few
    sweeps of the cap of 12 on random and graded matrices (condition up
    to 1e12), and agree with LAPACK to a few float64 roundings of the
    largest value."""
    rng = np.random.default_rng(side)
    U, _, Vt = np.linalg.svd(rng.standard_normal((250, side, side)))
    graded = np.einsum("bij,bj,bjk->bik", U,
                       10.0 ** -rng.uniform(0, 12, (250, side)), Vt)
    A = np.concatenate([rng.standard_normal((250, side, side)), graded])
    S = np.einsum("bij,bkj->bik", A, A) - 0.3 * np.eye(side)
    full_svd = megakernel_ref._jacobi_svd(_lol(A), 12)
    full_eig = megakernel_ref._psd_eigvals(_lol(S), 12)
    short_svd = megakernel_ref._jacobi_svd(_lol(A), 6)
    short_eig = megakernel_ref._psd_eigvals(_lol(S), 6)
    for a, b in zip(full_svd[0] + full_eig, short_svd[0] + short_eig):
        assert torch.equal(a, b)          # converged within 6 sweeps
    sig = np.sort(np.stack([s.numpy() for s in full_svd[0]], 1), 1)[:, ::-1]
    want = np.linalg.svd(A, compute_uv=False)
    assert (np.abs(sig - want).max(1) / want[:, 0]).max() < 4e-15
    ev = np.sort(np.stack([e.numpy() for e in full_eig], 1), 1)
    want = np.linalg.eigvalsh(S)
    assert (np.abs(ev - want).max(1) / np.abs(want).max(1)).max() < 1e-14
    # U diag(sig) V' reconstructs A
    sig, Um, Vm = (np.stack([s.numpy() for s in full_svd[0]], 1),
                   np.stack([np.stack([u.numpy() for u in r], 1)
                             for r in full_svd[1]], 1),
                   np.stack([np.stack([v.numpy() for v in r], 1)
                             for r in full_svd[2]], 1))
    rec = np.einsum("bij,bj,bkj->bik", Um, sig, Vm)
    scale = np.abs(A).max(axis=(1, 2))
    assert (np.abs(rec - A).max(axis=(1, 2)) / scale).max() < 1e-14


@pytest.mark.slow
@pytest.mark.parametrize("name", ["loop", "psd2", "psd_zero", "genpow"])
def test_psd_genpow_fixtures_regenerate(name):
    """The committed fixtures are what the JAX package computes now (the
    genpow megakernel alone compiles for about twenty minutes)."""
    fresh = fx.run_reference(name)
    f = np.load(fx.fixture_path(name))
    assert sorted(fresh) == sorted(f.files)
    for k in f.files:
        if f[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], f[k], rtol=1e-10,
                                       atol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(fresh[k], f[k])
