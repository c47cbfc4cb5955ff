"""The megakernel's float32 first phase (K1e's plain PyTorch version,
`BatchSolver(..., Settings(kkt_backend="megakernel",
megakernel_two_phase=True), device="cpu")`) against the JAX package.

The JAX megakernel compiles for minutes on the CPU, so the comparison is
against committed fixtures (`tests/torch_fixtures/make_two_phase_fixtures.py`):
its two-phase solve of 64 lanes of the n=2 layout of
`tests/test_megakernel.py` (every 8th lane infeasible), of the bench shape
and of the side-2 SDP batch, each with its single-phase solve beside it.

The bars: the port's SOLVED count at least the reference's (the
reference's two-phase solve may leave lanes ALMOST_SOLVED that its single
phase solves, so the bar is one-sided); on the lanes both solve,
objectives within 1e-6 (1 + |obj|), x within 1e-6 or the sum of both
solutions' certificate radii (clarabel_tpu_torch/DEVIATIONS.md #4), and
iterations within 4 (the reference's own allowance, docs/DEVIATIONS.md
#13); infeasible lanes detected where the reference detects them.
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
from clarabel_tpu_torch.ipm import megakernel, megakernel_ref

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
SOLVED = int(ctt.SolverStatus.SOLVED)
INFEASIBLE = (int(ctt.SolverStatus.PRIMAL_INFEASIBLE),
              int(ctt.SolverStatus.ALMOST_PRIMAL_INFEASIBLE))
TWO = ctt.Settings(kkt_backend="megakernel", megakernel_two_phase=True)
ONE = ctt.Settings(kkt_backend="megakernel")
NAMES = ("tiny", "bench", "psd2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_fixture(name):
    f = np.load(os.path.join(FIXTURES, f"two_phase_{name}.npz"))
    cones = [cone_from_tuple(tuple(c)) for c in json.loads(str(f["cones"]))]
    ref = {k[4:]: f[k] for k in f.files if k.startswith("ref_")}
    single = {k[7:]: f[k] for k in f.files if k.startswith("single_")}
    return cones, int(f["n"]), (f["P"], f["q"], f["A"], f["b"]), ref, single


@pytest.fixture(scope="module")
def solved():
    """name -> (data, the port's two-phase solution, its single-phase
    solution, the JAX two-phase and single-phase outputs)."""
    out = {}
    for name in NAMES:
        cones, n, data, ref, single = load_fixture(name)
        two = ctt.BatchSolver(cones, n, TWO, device="cpu").solve(*data)
        one = ctt.BatchSolver(cones, n, ONE, device="cpu").solve(*data)
        out[name] = (data, two, one, ref, single)
    return out


def certificate_radius(P, gap):
    """sqrt(2 gap / lambda_min(P)): how far x may sit from the optimum of
    a strongly convex QP whose solution has duality gap `gap`."""
    lam = np.linalg.eigvalsh(P)[:, 0]
    return np.sqrt(2.0 * np.abs(gap) / lam)


def assert_bars(sol, ref, data):
    P, q, A, b = data
    solved_ = sol.status == SOLVED
    rsolved = ref["status"] == SOLVED
    assert solved_.sum() >= rsolved.sum(), (sol.status, ref["status"])
    both = np.nonzero(solved_ & rsolved)[0]
    assert len(both) > 0
    radius = (certificate_radius(P, sol.obj_val - sol._out["obj_val_dual"])
              + certificate_radius(P, ref["obj_val"] - ref["obj_val_dual"]))
    for i in both:
        assert abs(sol.obj_val[i] - ref["obj_val"][i]) < 1e-6 * (
            1 + abs(ref["obj_val"][i])), i
        np.testing.assert_allclose(sol.x[i], ref["x"][i], rtol=0,
                                   atol=max(1e-6, radius[i]))
        assert abs(int(sol.iterations[i]) - int(ref["iterations"][i])) <= 4
    rinf = np.isin(ref["status"], INFEASIBLE)
    assert np.isin(sol.status[rinf], INFEASIBLE).all()
    for i in np.nonzero(solved_)[0]:
        rp = np.linalg.norm(A[i] @ sol.x[i] + sol.s[i] - b[i])
        rd = np.linalg.norm(P[i] @ sol.x[i] + q[i] + A[i].T @ sol.z[i])
        assert rp < 1e-7 and rd < 1e-7, (i, rp, rd)


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax_two_phase_fixture(solved, name):
    data, two, _, ref, _ = solved[name]
    assert_bars(two, ref, data)
    if name == "tiny":
        assert np.isin(two.status[::8], INFEASIBLE).all()


@pytest.mark.parametrize("name", NAMES)
def test_two_phase_answers_as_the_single_phase(solved, name):
    """The first phase moves the iterate where the float64 loop starts,
    not the answer: the port's two-phase solve meets the same bars against
    the JAX single phase, and its own single phase meets them against the
    JAX single-phase fixture."""
    data, two, one, _, single = solved[name]
    assert_bars(two, single, data)
    assert_bars(one, single, data)


def test_phase1_row_counts_the_float32_iterations(solved):
    """The kernel's fourth int row: every bench lane takes float32 steps
    before it hands off; none does where two-phase is off, and with
    switch_mu = 1e30 every lane hands off at once, which leaves the single
    phase's bits."""
    data, two, one, _, _ = solved["bench"]
    p1 = two._out["p1_iterations"]
    assert (p1 > 0).all() and (p1 < two.iterations).all()
    assert (one._out["p1_iterations"] == 0).all()
    cones, n, *_ = load_fixture("bench")
    off = ctt.BatchSolver(cones, n, TWO.replace(megakernel_switch_mu=1e30),
                          device="cpu").solve(*data)
    assert (off._out["p1_iterations"] == 0).all()
    for k in ("x", "z", "s", "status", "iterations", "obj_val"):
        np.testing.assert_array_equal(getattr(off, k), getattr(one, k))


def test_phase1_arithmetic_is_float32(monkeypatch):
    """Every predictor-corrector step of the first phase takes and returns
    float32 tensors over float32 data; the float64 loop's steps stay
    float64."""
    seen = []
    pc_step = megakernel_ref._pc_step

    def spy(ops, *args):
        out = pc_step(ops, *args)
        tensors = [ops.Ps, ops.As, ops.qe, ops.be] + [
            a for a in args[:8] if isinstance(a, torch.Tensor)] + [
            t for t in out if t.is_floating_point()]
        seen.append({t.dtype for t in tensors})
        return out

    monkeypatch.setattr(megakernel_ref, "_pc_step", spy)
    cones, n, data, *_ = load_fixture("tiny")
    ctt.BatchSolver(cones, n, TWO, device="cpu").solve(*(a[:8] for a in data))
    assert {torch.float32} in seen and {torch.float64} in seen
    assert all(len(d) == 1 for d in seen)
    first64 = seen.index({torch.float64})
    assert all(d == {torch.float32} for d in seen[:first64])


@pytest.mark.parametrize("layout", ["zero", "exp"])
def test_two_phase_is_a_no_op_where_the_reference_turns_it_off(layout):
    """A zero cone or a nonsymmetric segment turns the float32 phase off
    (clarabel_tpu/ipm/megakernel.py:559-568): the same bits as the single
    phase, no phase-1 iteration."""
    if layout == "zero":
        cones = [ctt.ZeroConeT(1), ctt.NonnegativeConeT(7)]
        n, data = 6, bench_data.make_qp_eq(16, 6, 1)
    else:
        cones = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
        n, data = 3, bench_data.make_exp_batch(16)
    two = ctt.BatchSolver(cones, n, TWO, device="cpu")
    assert not two._mega_fn.spec.two_phase
    a = two.solve(*data)
    b = ctt.BatchSolver(cones, n, ONE, device="cpu").solve(*data)
    assert (a._out["p1_iterations"] == 0).all()
    for k in ("x", "z", "s", "status", "iterations", "obj_val", "r_prim"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_phase1_cap_is_min_25_and_max_iter():
    """p1_cap = min(25, max_iter) (reference l.570); a switch_mu no lane
    reaches keeps a lane in the first phase until its mu stalls or the
    cap, never past it."""
    cones = [ctt.NonnegativeConeT(2), ctt.SecondOrderConeT(2)]
    lay = ConeLayout(cones)
    for max_iter, cap in ((200, 25), (25, 25), (7, 7)):
        spec = megakernel.make_spec(lay, TWO.replace(max_iter=max_iter), 2)
        assert spec.two_phase and spec.p1_cap == cap
        assert spec.switch_mu == TWO.megakernel_switch_mu
    _, n, data, *_ = load_fixture("tiny")
    for max_iter in (200, 4):
        st = TWO.replace(megakernel_switch_mu=1e-30, max_iter=max_iter)
        sol = ctt.BatchSolver(cones, n, st, device="cpu").solve(*data)
        p1 = sol._out["p1_iterations"]
        assert p1.max() <= min(25, max_iter)
        assert (p1 <= sol.iterations).all()
        if max_iter == 200:
            # the default switch hands lanes off after 4-6 steps; here the
            # stall rule or the cap ends the first phase later
            assert p1.mean() > 8
        else:
            assert (p1 == 4).all()


def _lol(A):
    T = torch.from_numpy(A)
    return [[T[:, i, j] for j in range(A.shape[2])] for i in range(A.shape[1])]


def test_float32_jacobi_sweeps_stop_at_float32_rounding():
    """The first phase's Jacobi stop rule (DEVIATIONS.md #12): on float32
    matrices of side 3 the sweeps stop within 4 with the float32 unit
    roundoff, and agree with LAPACK to a few float32 roundings; the
    float64 rule keeps rotating on rounding noise until the cap."""
    rng = np.random.default_rng(3)
    U, _, Vt = np.linalg.svd(rng.standard_normal((250, 3, 3)))
    graded = np.einsum("bij,bj,bjk->bik", U,
                       10.0 ** -rng.uniform(0, 6, (250, 3)), Vt)
    A = np.concatenate([rng.standard_normal((250, 3, 3)),
                        graded]).astype(np.float32)
    S = (np.einsum("bij,bkj->bik", A, A)
         - 0.3 * np.eye(3)).astype(np.float32)
    eps32, eps64 = megakernel_ref.EPS32, megakernel_ref.EPS64

    def run(sweeps, eps):
        sig, _, _ = megakernel_ref._jacobi_svd(_lol(A), sweeps, eps)
        return sig + megakernel_ref._psd_eigvals(_lol(S), sweeps, eps)

    full = run(12, eps32)
    assert all(torch.equal(a, b) for a, b in zip(full, run(4, eps32)))
    assert not all(torch.equal(a, b)
                   for a, b in zip(run(12, eps64), run(8, eps64)))
    assert all(t.dtype == torch.float32 for t in full)
    sig = np.sort(np.stack([s.numpy() for s in full[:3]], 1), 1)[:, ::-1]
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert (np.abs(sig - want).max(1) / want[:, 0]).max() < 1e-6
    ev = np.sort(np.stack([e.numpy() for e in full[3:]], 1), 1)
    want = np.linalg.eigvalsh(S.astype(np.float64))
    assert (np.abs(ev - want).max(1) / np.abs(want).max(1)).max() < 2e-6


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_two_phase_fixtures_regenerate(name):
    """The committed fixtures are what the JAX package computes now (each
    case compiles the JAX megakernel twice, minutes per program)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_two_phase_fixtures",
        os.path.join(FIXTURES, "make_two_phase_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.run_reference(name)
    f = np.load(mod.fixture_path(name))
    assert sorted(fresh) == sorted(f.files)
    for k in f.files:
        if f[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], f[k], rtol=1e-10,
                                       atol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(fresh[k], f[k])
