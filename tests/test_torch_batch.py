"""BatchSolver of the PyTorch port: argument checking, the slice's limits,
backend and device selection, the host-side packing around the megakernel,
the loop paths and the rescue cascade on the CPU, and (on a card only) the
CUDA kernels against their plain versions.

Imports only the port, so that the card-only test runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_batch.py
"""

import os

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref
from clarabel_tpu_torch.linalg import batched_ldl
from clarabel_tpu_torch.parallel import batch_impl

N = 3
CONES = [ctt.NonnegativeConeT(N), ctt.SecondOrderConeT(N + 1)]
CONES_BENCH = [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)]
MEGA = ctt.Settings(kkt_backend="megakernel")
SOLVED = int(ctt.SolverStatus.SOLVED)


def _batch(B, seed=0):
    return bench_data.make_batch(B, N, seed)


def _solver(cones=CONES, n=N, settings=MEGA, **kw):
    return ctt.BatchSolver(cones, n, settings, device="cpu", **kw)


@pytest.mark.parametrize("which", ["P", "q", "A", "b", "A_rows"])
def test_shape_errors_raise_value_error(which):
    P, q, A, b = _batch(4)
    bad = {"P": (P[:, :2], q, A, b), "q": (P, q[:, :2], A, b),
           "A": (P, q, A[:, :, :2], b), "b": (P, q, A, b[:, :3]),
           "A_rows": (P, q, A[:, 1:], b)}[which]
    with pytest.raises(ValueError):
        _solver().solve(*bad)


def test_empty_batch_raises_value_error():
    P, q, A, b = _batch(1)
    with pytest.raises(ValueError):
        _solver().solve(P[:0], q[:0], A[:0], b[:0])


@pytest.mark.parametrize("cone", [
    ctt.GenPowerConeT((0.2, 0.3, 0.5), 2), ctt.PSDTriangleConeT(3),
    ctt.GenPowerConeT((0.4, 0.6), 1), ctt.PSDTriangleConeT(2)])
def test_cones_now_in_the_slice_solve(cone):
    """Generalized power and PSD cones beside a nonnegative cone: x within
    [-1, 1] (the nn rows) and a point of the cone at distance at most 0.1
    of a center, on the megakernel's plain version and on the loop."""
    from clarabel_tpu_torch.cones.api import nvars
    k = nvars(cone)
    rng = np.random.default_rng(k)
    B, n = 8, k
    if isinstance(cone, ctt.PSDTriangleConeT):
        center = bench_data._svec(np.eye(cone.dim))
    else:
        center = np.concatenate([np.ones(len(cone.alpha)),
                                 np.zeros(cone.dim2)])
    P = np.broadcast_to(np.eye(n), (B, n, n)).copy()
    q = rng.standard_normal((B, n))
    A = np.concatenate([np.broadcast_to(np.eye(n), (B, n, n)),
                        -np.broadcast_to(np.eye(n), (B, n, n)),
                        -np.broadcast_to(np.eye(k), (B, k, k)) * 10.0], 1)
    b = np.concatenate([np.ones((B, 2 * n)),
                        np.broadcast_to(10.0 * center, (B, k))], 1)
    cones = [ctt.NonnegativeConeT(2 * n), cone]
    for st in (MEGA, ctt.Settings(kkt_backend="condensed")):
        sol = _solver(cones, n, st).solve(P, q, A, b)
        assert sol.all_solved, sol.status
        assert np.isfinite(sol.x).all()


@pytest.mark.parametrize("change", [
    {"kkt_backend": "blockarrow"}, {"kkt_backend": "multifrontal"}])
def test_settings_outside_the_slice_raise(change):
    """These backends once raised here; now they solve.  BatchSolver
    passes no structure plan, so the reference runs its dense ldl loop for
    both, and so does the port's BatchSolver (the single-instance Solver
    analyzes the pattern for a plan: tests/test_torch_structured_solver.py):
    on the example batch of __graft_entry__.py
    the reference's statuses (tests/torch_fixtures/faults.npz), x within
    the bench bar of DEVIATIONS.md #4 (1e-4), the objective within 1e-6,
    iterations within 4, and the bits of the port's own ldl loop."""
    bk = change["kkt_backend"]
    data = bench_data.make_batch(4, 6, 0)
    sol = _solver(CONES_BENCH, 6, ctt.Settings(**change)).solve(*data)
    ldl = _solver(CONES_BENCH, 6, ctt.Settings(kkt_backend="ldl")).solve(
        *data)
    fix = np.load(os.path.join(os.path.dirname(__file__), "torch_fixtures",
                               "faults.npz"))
    np.testing.assert_array_equal(sol.status, fix[f"{bk}_status"])
    assert np.abs(sol.x - fix[f"{bk}_x"]).max() < 1e-4
    assert np.abs(sol.obj_val - fix[f"{bk}_obj_val"]).max() < 1e-6
    assert np.abs(sol.iterations - fix[f"{bk}_iterations"]).max() <= 4
    np.testing.assert_array_equal(sol.x, ldl.x)


@pytest.mark.parametrize("change", [
    {"megakernel_two_phase": True}, {"factor_dtype": "float32"}])
def test_megakernel_settings_now_in_the_slice_solve(change):
    """The float32 first phase (K1e) and float32 factors, which the
    megakernel ignores as the reference does, run on the megakernel."""
    P, q, A, b = _batch(16)
    bs = _solver(settings=MEGA.replace(**change))
    assert bs._mega_fn is not None
    assert bs._mega_fn.spec.two_phase == change.get("megakernel_two_phase",
                                                    False)
    sol = bs.solve(P, q, A, b)
    assert sol.all_solved, sol.status
    assert sol.x.shape == (16, N) and np.isfinite(sol.x).all()


def test_megakernel_ignores_factor_dtype():
    """The same bits with float32 factors as without, and "auto" still
    resolves to the megakernel on a card (resolve_backend reads only the
    device's type)."""
    P, q, A, b = _batch(16)
    a = _solver(settings=MEGA.replace(factor_dtype="float32")).solve(
        P, q, A, b)
    ref = _solver().solve(P, q, A, b)
    for k in ("x", "z", "s", "status", "iterations", "obj_val"):
        np.testing.assert_array_equal(getattr(a, k), getattr(ref, k))
    st = ctt.Settings(factor_dtype="float32")
    assert batch_impl.resolve_backend(ConeLayout(CONES), st, N,
                                      torch.device("cuda")) == "megakernel"


F32_TOLS = {"tol_gap_abs": 1e-5, "tol_gap_rel": 1e-5, "tol_feas": 1e-5}


@pytest.mark.parametrize("change", [
    {"kkt_backend": "condensed"}, {"kkt_backend": "ldl"},
    {"mixed_precision": True}, {"factor_dtype": "float32"},
    dict(F32_TOLS, dtype="float32"),
    dict(F32_TOLS, dtype="float32", kkt_backend="ldl", use_pallas=True)])
def test_settings_now_in_the_slice_solve(change):
    """The loop solver runs what the megakernel path does not take."""
    P, q, A, b = _batch(16)
    bs = _solver(settings=ctt.Settings(**change))
    assert bs._mega_fn is None
    sol = bs.solve(P, q, A, b)
    assert (sol.status == SOLVED).sum() >= 12, sol.status
    assert sol.x.shape == (16, N) and np.isfinite(sol.x).all()


def test_options_outside_the_slice_raise():
    """What once raised for ROADMAP.md item 13 now runs: a mesh that is
    not a DeviceMesh raises TypeError, the megakernel refuses a mesh as
    the reference's does, and a mesh of one rank solves with the unsharded
    solve's bits (tests/test_torch_multidevice.py holds the sharded
    paths); a rescue that does not exist still raises."""
    from test_torch_multidevice import world_of_one

    with pytest.raises(TypeError, match="DeviceMesh"):
        _solver(mesh=object())
    with pytest.raises(ValueError, match="rescue"):
        _solver(rescue="gpu")
    P, q, A, b = _batch(8)
    ref = _solver(settings=ctt.Settings()).solve(P, q, A, b)
    with world_of_one("gloo", "cpu") as mesh:
        with pytest.raises(ValueError, match="megakernel"):
            _solver(mesh=mesh)
        got = _solver(settings=ctt.Settings(), mesh=mesh).solve(P, q, A, b)
    for k in ("status", "iterations", "x", "obj_val"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


@pytest.mark.parametrize("kw", [{"rescue": "cpu"}, {"rescue": "same"},
                                {"rescue_settings": ctt.Settings()}])
def test_rescue_options_now_in_the_slice_solve(kw):
    P, q, A, b = _batch(16)
    sol = _solver(**kw).solve(P, q, A, b)
    assert sol.all_solved


def test_layouts_outside_the_megakernel_regime():
    """Too wide for the megakernel: "auto" takes the condensed loop, an
    explicit megakernel is refused."""
    big = [ctt.NonnegativeConeT(4)]
    bs = _solver(big, 40, ctt.Settings())
    assert bs._mega_fn is None and bs._solve_fn is not None
    with pytest.raises(ValueError, match="megakernel"):
        _solver(big, 40, ctt.Settings(kkt_backend="megakernel"))


def test_auto_resolves_as_the_reference_does():
    """"auto" is the megakernel on a card only; elsewhere it is condensed,
    or the dense ldl loop when the layout has a zero cone
    (clarabel_tpu/parallel/batch_impl.py:110-120)."""
    st = ctt.Settings()
    lay = ConeLayout(CONES)
    zero = ConeLayout([ctt.ZeroConeT(1)] + CONES)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    resolve = batch_impl.resolve_backend
    assert resolve(lay, st, N, cuda) == "megakernel"
    assert resolve(lay, st, N, cpu) == "condensed"
    assert resolve(zero, st, N, cpu) == "ldl"
    assert resolve(lay, st.replace(dtype="float32"), N, cuda) == "condensed"
    assert resolve(zero, st, 40, cuda) == "ldl"
    assert resolve(lay, ctt.Settings.throughput(), N, cuda) == "ldl"
    bs = ctt.BatchSolver(CONES, N, st, device="cpu")
    assert bs._mega_fn is None


def _marginal_batch():
    """The batch of tests/test_megakernel.py test_rescue_closes_marginal_lanes
    (n=2, seed 1)."""
    rng = np.random.default_rng(1)
    B, n = 8, 2
    F = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", F, F) + np.eye(n)
    q = rng.standard_normal((B, n))
    A = np.tile(np.vstack([np.eye(n), [[1.0, 0.3], [0.2, 1.0]]]), (B, 1, 1))
    b = np.abs(rng.standard_normal((B, 4))) + 1.0
    return [ctt.NonnegativeConeT(2), ctt.SecondOrderConeT(2)], n, (P, q, A, b)


def test_rescue_closes_marginal_lanes():
    """The port of tests/test_megakernel.py:98-105, and the same batch with
    the megakernel cut at 6 iterations, so that the cascade has lanes to
    close: every lane ends SOLVED, and a rescued lane carries the rescue
    solver's solution."""
    cones, n, data = _marginal_batch()
    rs = ctt.Settings(kkt_backend="condensed")
    bs = ctt.BatchSolver(cones, n, MEGA, rescue="same", rescue_settings=rs,
                         device="cpu")
    assert bs.solve(*data).all_solved
    cut = MEGA.replace(max_iter=6)
    before = ctt.BatchSolver(cones, n, cut, device="cpu").solve(*data)
    failed = np.nonzero(before.status != SOLVED)[0]
    assert len(failed) >= 4
    out = ctt.BatchSolver(cones, n, cut, rescue="same", rescue_settings=rs,
                          device="cpu").solve(*data)
    assert out.all_solved
    direct = ctt.BatchSolver(cones, n, rs, device="cpu").solve(*data)
    np.testing.assert_array_equal(out.x[failed], direct.x[failed])
    np.testing.assert_array_equal(out.z[failed], direct.z[failed])
    kept = before.status == SOLVED
    np.testing.assert_array_equal(out.x[kept], before.x[kept])


def test_rescue_merge_leaves_z_and_s_lazy_until_read():
    cones, n, data = _marginal_batch()
    cut = MEGA.replace(max_iter=6)
    rs = ctt.Settings(kkt_backend="condensed")
    sol = ctt.BatchSolver(cones, n, cut, rescue="cpu", rescue_settings=rs,
                          device="cpu").solve(*data)
    out = sol._out
    assert out._pending and out._fetch is not None
    assert "z" not in dict.keys(out) and "s" not in dict.keys(out)
    direct = ctt.BatchSolver(cones, n, rs, device="cpu").solve(*data)
    take = out._pending[0][0]
    np.testing.assert_array_equal(sol.s[take], direct.s[take])
    assert not out._pending and "z" in dict.keys(out)
    np.testing.assert_array_equal(sol.z[take], direct.z[take])
    np.testing.assert_array_equal(out["r_prim"][take],
                                  direct._out["r_prim"][take])


def test_rescue_cascade_pads_to_a_power_of_two():
    """Three failed lanes of 40 go to the rescue as one 32-lane batch that
    cycles them; the first stage solves them, so no later stage runs."""
    P, q, A, b = _batch(40)
    bs = _solver(rescue="same")
    out = {k: np.array(v) for k, v in dict(bs.solve(P, q, A, b)._out).items()}
    failed = np.array([3, 17, 30])
    out["status"][failed] = int(ctt.SolverStatus.ALMOST_SOLVED)
    seen = []

    def recorder(fn):
        def run(*args):
            seen.append(args[1].numpy())
            return fn(*args)
        return run

    bs._rescue_fns = [recorder(fn) for fn in bs._rescue_fns]
    out = bs._rescue_pass(out, P, q, A, b)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], q[np.resize(failed, 32)])
    assert (out["status"] == SOLVED).all()


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctt.BatchSolver(CONES, N)


def test_cpu_solve_runs_the_plain_version_and_never_the_kernel():
    before = _cuda.megakernel.launches
    P, q, A, b = _batch(16)
    sol = _solver().solve(P, q, A, b)
    assert _cuda.megakernel.launches == before == 0
    assert sol.all_solved
    assert sol.x.shape == (16, N) and sol.z.shape == (16, 2 * N + 1)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, sol.x) + sol.s,
                               b, atol=1e-7)


def test_the_wrapper_refuses_cpu_tensors():
    bs = _solver()
    _, flats = megakernel.prepare(*_batch(4), bs._mega_fn.spec, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.megakernel(*flats, bs._mega_fn.spec, 4)
    assert _cuda.megakernel.launches == 0


def test_upper_triangular_P_gives_the_same_solution():
    P, q, A, b = _batch(8)
    bs = _solver()
    full = bs.solve(P, q, A, b)
    triu = bs.solve(np.triu(P), q, A, b)
    np.testing.assert_array_equal(full.x, triu.x)
    np.testing.assert_array_equal(full.iterations, triu.iterations)


def test_prepare_passes_batch_constant_components_once():
    P, q, A, b = _batch(8)
    spec = _solver()._mega_fn.spec
    B, flats = megakernel.prepare(P, q, A, b, spec, "cpu")
    assert B == 8
    assert [f.dim() for f in flats] == [2, 2, 1, 2]   # A is the same
    assert flats[2].shape == (N * spec.m,)
    # the shared A and its broadcast copy give the same solve
    wide = flats[2][:, None].expand(-1, B).contiguous()
    v1, i1 = megakernel_ref.mega_solve_plain(*flats, spec, B)
    v2, i2 = megakernel_ref.mega_solve_plain(flats[0], flats[1], wide,
                                             flats[3], spec, B)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    assert v1.shape == (spec.outd, B) and i1.shape == (4, B)


def _identical_lanes(B):
    """B copies of lane 0 of a bench batch: every component of the batch
    is batch-constant."""
    return tuple(np.repeat(a[:1], B, axis=0) for a in _batch(1))


def _assert_every_lane_is_the_one_solve(sol, one, B, m):
    assert sol.x.shape == (B, N) and sol.z.shape == (B, m)
    assert sol.status.shape == sol.iterations.shape == (B,)
    for got, want in ((sol.x, one.x), (sol.z, one.z), (sol.s, one.s),
                      (sol.obj_val, one.obj_val), (sol.status, one.status),
                      (sol.iterations, one.iterations)):
        np.testing.assert_array_equal(got, np.repeat(want, B, axis=0))


def test_identical_lanes_solve_every_lane():
    B = 5
    data = _identical_lanes(B)
    bs = _solver()
    _, flats = megakernel.prepare(*data, bs._mega_fn.spec, "cpu")
    assert [f.dim() for f in flats] == [1, 1, 1, 1]
    sol = bs.solve(*data)
    one = bs.solve(*(a[:1] for a in data))
    assert one.all_solved
    _assert_every_lane_is_the_one_solve(sol, one, B, bs.m)


def test_outputs_stay_lazy_until_read():
    P, q, A, b = _batch(8)
    sol = _solver().solve(P, q, A, b)
    out = sol._out
    assert "z" not in dict.keys(out)
    z = sol.z
    assert z.shape == (8, 2 * N + 1)
    assert set(megakernel.REST_NAMES) <= set(dict.keys(out))


def test_kernel_source_and_params_cover_the_spec():
    spec = _solver([ctt.ZeroConeT(1)] + CONES)._mega_fn.spec
    assert _cuda.shape_of(spec) == (N, 1 + 2 * N + 1, 3, 0, 0, 0, 0)
    prm = _cuda._params(spec)
    assert list(prm.seg_kind) == [0, 1, 2]
    assert list(prm.seg_hi) == [1, 1 + N, 2 + 2 * N]
    assert prm.refine_passes == 4 and prm.max_iter == 200
    path = _cuda.megakernel.lib_path(_cuda.shape_of(spec))
    assert path.endswith(".so") and "n3_m8_s3" in path


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    # the qp_eq batch pins x to ~1e-12 under rounding; the SOC batches
    # only to ~1e-5 at 1e-8 tolerances (clarabel_tpu_torch/DEVIATIONS.md)
    bs = ctt.BatchSolver([ctt.ZeroConeT(1), ctt.NonnegativeConeT(N + 1)], N)
    spec = bs._mega_fn.spec
    _, flats = megakernel.prepare(*bench_data.make_qp_eq(256, N, 1), spec,
                                  "cuda")
    before = _cuda.megakernel.launches
    kv, ki = _cuda.megakernel(*flats, spec, 256)
    torch.cuda.synchronize()
    assert _cuda.megakernel.launches == before + 1
    pv, pi = megakernel_ref.mega_solve_plain(*flats, spec, 256)
    assert torch.equal(ki, pi)
    assert (ki[0] == int(ctt.SolverStatus.SOLVED)).all()
    rows = list(range(N)) + [N + 2 * spec.m]    # x and the objective
    assert torch.allclose(kv[rows], pv[rows], rtol=0, atol=1e-6)
    # a batch whose every component is batch-constant still solves B lanes
    bs = ctt.BatchSolver(CONES, N)
    data = _identical_lanes(7)
    sol = bs.solve(*data)
    one = bs.solve(*(a[:1] for a in data))
    assert one.all_solved
    _assert_every_lane_is_the_one_solve(sol, one, 7, bs.m)


@pytest.mark.gpu
def test_nonsym_kernel_matches_plain_version_on_the_card():
    """K1b on the exponential batch of bench.py and on a power batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    for cone, make in ((ctt.ExponentialConeT(), bench_data.make_exp_batch),
                       (ctt.PowerConeT(0.6), bench_data.make_pow_batch)):
        bs = ctt.BatchSolver([ctt.NonnegativeConeT(2), cone], 3)
        spec = bs._mega_fn.spec
        assert _cuda.shape_of(spec) == (3, 5, 2, 1, 0, 0, 0)
        _, flats = megakernel.prepare(*make(256), spec, "cuda")
        before = _cuda.megakernel.launches
        kv, ki = _cuda.megakernel(*flats, spec, 256)
        torch.cuda.synchronize()
        assert _cuda.megakernel.launches == before + 1
        pv, pi = megakernel_ref.mega_solve_plain(*flats, spec, 256)
        assert (ki[0] == SOLVED).sum() >= (pi[0] == SOLVED).sum() - 1
        both = (ki[0] == SOLVED) & (pi[0] == SOLVED)
        obj = 3 + 2 * spec.m
        # flat optima: x to 1e-4, the objective to 1e-6 (DEVIATIONS.md #11)
        assert torch.allclose(kv[:3][:, both], pv[:3][:, both], rtol=0,
                              atol=1e-4)
        assert torch.allclose(kv[obj][both], pv[obj][both], rtol=0,
                              atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["psd3", "psd2", "psd_zero", "genpow"])
def test_psd_and_genpow_kernels_match_plain_version_on_the_card(name):
    """K1d on the SDP batches, K1c on the genpow batch: the kernel against
    its plain version on the card, and BatchSolver.solve launches it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    psd2 = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(2)]
    cones, n, data = {
        "psd3": ([ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3,
                 bench_data.make_sdp_batch(256, 3, 13)),
        "psd2": (psd2, 3, bench_data.make_sdp_batch(256, 2, 12)),
        "psd_zero": ([ctt.ZeroConeT(1), ctt.NonnegativeConeT(5),
                      ctt.PSDTriangleConeT(2)], 3,
                     bench_data.make_sdp_zero_batch(256)),
        "genpow": ([ctt.NonnegativeConeT(2),
                    ctt.GenPowerConeT((0.3, 0.7), 2)], 4,
                   bench_data.make_genpow_batch(256)),
    }[name]
    bs = ctt.BatchSolver(cones, n)
    spec = bs._mega_fn.spec
    _, flats = megakernel.prepare(*data, spec, "cuda")
    kv, ki = _cuda.megakernel(*flats, spec, 256)
    torch.cuda.synchronize()
    pv, pi = megakernel_ref.mega_solve_plain(*flats, spec, 256)
    assert (ki[0] == SOLVED).sum() >= (pi[0] == SOLVED).sum() - 1
    both = (ki[0] == SOLVED) & (pi[0] == SOLVED)
    obj = n + 2 * spec.m
    # x to 1e-4 (flat optima, as K1b), the objective to 1e-6
    assert torch.allclose(kv[:n][:, both], pv[:n][:, both], rtol=0,
                          atol=1e-4)
    assert torch.allclose(kv[obj][both], pv[obj][both], rtol=0, atol=1e-6)
    assert (ki[2] == pi[2]).all()
    before = _cuda.megakernel.launches
    assert bs.solve(*data).status.tolist() == ki[0].tolist()
    assert _cuda.megakernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(6, 13), (30, 50)])
def test_ldl_kernel_matches_plain_version_on_the_card(n, m):
    """K2 at N = 19 (the bench shape's KKT) and N = 80 (its largest N)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    K, signs = bench_data.make_kkts(1000, n, m, seed=n)
    K = torch.tensor(K, dtype=torch.float32, device="cuda")
    signs = torch.tensor(signs, dtype=torch.float32, device="cuda")
    before = batched_ldl.kernel.launches
    Linv, d, ok = batched_ldl.batched_ldl_inverse(K, signs)
    torch.cuda.synchronize()
    assert batched_ldl.kernel.launches == before + 1
    pLinv, pd, pok = batched_ldl.ldl_inverse_plain(K, signs)
    assert ok.all() and torch.equal(ok, pok)
    # float32 elimination, FMA-contracted on the card: relative to |L⁻¹|
    scale = pLinv.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1.0)
    assert ((Linv - pLinv).abs() / scale).max() < 1e-4
    assert ((d - pd).abs() / pd.abs().clamp_min(1.0)).max() < 1e-4


@pytest.mark.gpu
def test_throughput_path_launches_the_ldl_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    data = _batch(256)
    before = batched_ldl.kernel.launches
    sol = ctt.BatchSolver(CONES, N, ctt.Settings.throughput()).solve(*data)
    assert batched_ldl.kernel.launches > before
    plain = ctt.BatchSolver(CONES, N, ctt.Settings.throughput(use_pallas=True),
                            device="cpu").solve(*data)
    assert abs(int((sol.status == SOLVED).sum())
               - int((plain.status == SOLVED).sum())) <= 3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bench", "psd3"])
def test_two_phase_kernel_matches_plain_version_on_the_card(name):
    """K1e: BatchSolver with megakernel_two_phase launches the two-phase
    library, whose phase-1 counts and results meet the CPU tests' bars
    against its plain version on the card (x to 1e-4 at n=6, as K1a; the
    objective to 1e-6; iterations within 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    cones, n, data = {
        "bench": (CONES_BENCH, 6, bench_data.make_batch(256, 6, 0)),
        "psd3": ([ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3,
                 bench_data.make_sdp_batch(256, 3, 13)),
    }[name]
    bs = ctt.BatchSolver(cones, n, ctt.Settings(megakernel_two_phase=True))
    spec = bs._mega_fn.spec
    assert spec.two_phase and _cuda.shape_of(spec)[6] == 1
    before = _cuda.megakernel.two_phase_launches
    sol = bs.solve(*data)
    assert _cuda.megakernel.two_phase_launches == before + 1
    _, flats = megakernel.prepare(*data, spec, "cuda")
    pv, pi = megakernel_ref.mega_solve_plain(*flats, spec, 256)
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
    assert (sol.status == SOLVED).sum() >= (pi[0] == SOLVED).sum() - 1
    both = (sol.status == SOLVED) & (pi[0] == SOLVED)
    assert np.abs(sol.x[both] - pv[:n, both].T).max() < 1e-4
    obj = n + 2 * spec.m
    assert np.abs(sol.obj_val[both] - pv[obj, both]).max() < 1e-6
    assert np.abs(sol.iterations[both] - pi[1, both]).max() <= 4
    p1 = sol._out["p1_iterations"]
    assert (p1 > 0).all() and np.abs(p1 - pi[3]).max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["genpow", "psd3"])
def test_family_kernel_meets_the_smoke_bars_on_the_card(name):
    """K1c on the genpow batch and K1d on psd3 at chip_smoke.py's B
    (FAMILY_B = 4096, the first lanes of its largest batch), each held to
    its plain version on the card by chip_smoke.py's bars (GENPOW_BARS,
    PSD_BARS); every genpow lane ends on the Dual strategy in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    import chip_smoke as cs
    B = cs.FAMILY_B
    big = max(cs.FAMILY_THROUGHPUT)
    if name == "genpow":
        cones, n = [ctt.NonnegativeConeT(2),
                    ctt.GenPowerConeT((0.3, 0.7), 2)], 4
        data, bars = bench_data.make_genpow_batch(big), cs.GENPOW_BARS[name]
    else:
        cones, n = [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3
        data, bars = bench_data.make_sdp_batch(big, 3, 13), cs.PSD_BARS[name]
    P, q, A, b = (a[:B] for a in data)
    spec = ctt.BatchSolver(cones, n)._mega_fn.spec
    _, flats = megakernel.prepare(P, q, A, b, spec, "cuda")
    before = _cuda.megakernel.launches
    kv, ki = _cuda.megakernel(*flats, spec, B)
    torch.cuda.synchronize()
    assert _cuda.megakernel.launches == before + 1
    pv, pi = megakernel_ref.mega_solve_plain(*flats, spec, B)
    k, p = cs.outputs(kv, ki, spec), cs.outputs(pv, pi, spec)
    r = cs.readings(k, p, P, q, A, b)
    assert not cs.violations(r, bars, B), cs.describe(r)
    if name == "genpow":
        assert bool((ki[2] == 1).all()) and bool((pi[2] == 1).all())


@pytest.mark.gpu
def test_multifrontal_takes_float32_factors_on_the_card():
    """kkt_backend="multifrontal" resolves its factor dtype as the
    reference does off a CPU: float32 factors, refined in float64, which at
    N = 19 is the K2 route; "ldl" keeps float64 factors and no K2.  The
    float32 factor's refinement stalls near the optimum, so lanes end
    SOLVED or ALMOST_SOLVED (on the card 63 of these 256 SOLVED, the rest
    ALMOST_SOLVED; DEVIATIONS.md #6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    data = bench_data.make_batch(256, 6, 0)
    before = batched_ldl.kernel.launches
    mf = ctt.BatchSolver(CONES_BENCH, 6,
                         ctt.Settings(kkt_backend="multifrontal")).solve(*data)
    assert batched_ldl.kernel.launches > before
    before = batched_ldl.kernel.launches
    ldl = ctt.BatchSolver(CONES_BENCH, 6,
                          ctt.Settings(kkt_backend="ldl")).solve(*data)
    assert batched_ldl.kernel.launches == before
    almost = int(ctt.SolverStatus.ALMOST_SOLVED)
    assert np.isin(mf.status, [SOLVED, almost]).all(), mf.status
    both = (mf.status == SOLVED) & (ldl.status == SOLVED)
    assert both.any()
    assert np.abs(mf.obj_val[both] - ldl.obj_val[both]).max() < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["throughput", "exp"])
def test_loop_graph_replay_matches_eager_on_the_card(path, monkeypatch):
    """On a card the loop solver captures its IPM pass as a CUDA graph
    (zero/nn/SOC/exp layouts) and replays it; with the pass left eager
    (`loop.GRAPH_KINDS` emptied) every output has the same bits, and the
    replays count K2's launches as the eager passes do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    from clarabel_tpu_torch.ipm import loop

    if path == "throughput":
        cones, n, st = CONES_BENCH, 6, ctt.Settings.throughput()
        data = bench_data.make_batch(1024, 6, 0)
    else:
        cones = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
        n, st = 3, ctt.Settings(kkt_backend="condensed")
        data = bench_data.make_exp_batch(1024)

    def run():
        before = batched_ldl.kernel.launches
        out = ctt.BatchSolver(cones, n, st).solve(*data)._out
        return out, batched_ldl.kernel.launches - before

    graphed, k2_graphed = run()
    monkeypatch.setattr(loop, "GRAPH_KINDS", frozenset())
    eager, k2_eager = run()
    assert k2_graphed == k2_eager
    assert (k2_eager > 0) == (path == "throughput")
    for key, want in eager.items():
        got = graphed[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                              np.ascontiguousarray(want).view(np.uint8)), key


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["grid", "rank2"])
def test_sparse_solver_graph_replay_matches_eager_on_the_card(case,
                                                              monkeypatch):
    """The sparse Solver's IPM pass (multifrontal on a grid QP, block-arrow
    with the rank-2 SMW correction on robust least squares) replayed as a
    CUDA graph gives the bits of the pass left eager, and counts the
    factorizations it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    from clarabel_tpu_torch import api
    from clarabel_tpu_torch.ipm import loop

    if case == "grid":
        P, q, A, b = bench_data.grid_qp_sparse(20)
        cones, st = [ctt.NonnegativeConeT(400)], ctt.Settings(
            sparse_data=True)
    else:
        P, q, A, b, cones, _, _ = bench_data.robust_ls_banded(240, 80)
        st = ctt.Settings()

    def run():
        api._SOLVE_CACHE.clear()
        solver = ctt.Solver(P, q, A, b, cones, st)
        sol = solver.solve()
        return sol, solver._solve_fn.counts["factorizations"]

    graphed, f_graphed = run()
    monkeypatch.setattr(loop, "GRAPH_KINDS", frozenset())
    eager, f_eager = run()
    api._SOLVE_CACHE.clear()
    assert graphed.status == eager.status == ctt.SolverStatus.SOLVED
    assert graphed.iterations == eager.iterations
    assert f_graphed == f_eager
    for key in ("x", "z", "s"):
        assert np.array_equal(getattr(graphed, key), getattr(eager, key)), key


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(2, 3), (6, 13), (10, 22), (10, 23),
                                 (26, 53), (30, 50)])
def test_ldl_rows_kernel_matches_plain_version_on_the_card(n, m):
    """K2's rows design (one library per N: csrc/ldl_inverse_rows.cu at
    N = 5, 19 and 32, csrc/ldl_inverse_rows_wide.cu at N = 33, 79 and 80),
    against its plain version, and on every ok lane bit for bit against
    the shared-memory kernel (csrc/ldl_inverse.cu), the simple kernel it
    is held to: both update each entry by the same expression in the same
    order of j."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    K, signs = bench_data.make_kkts(1000, n, m, seed=n)
    K = torch.tensor(K, dtype=torch.float32, device="cuda")
    signs = torch.tensor(signs, dtype=torch.float32, device="cuda")
    src = ("ldl_inverse_rows.cu" if n + m <= batched_ldl.ONE_WARP_MAX_N
           else "ldl_inverse_rows_wide.cu")
    before = batched_ldl.kernel.source_launches.copy()
    Linv, d, ok = batched_ldl.batched_ldl_inverse(K, signs)
    torch.cuda.synchronize()
    before[src] += 1
    assert batched_ldl.kernel.source_launches == before
    pLinv, pd, pok = batched_ldl.ldl_inverse_plain(K, signs)
    assert ok.all() and torch.equal(ok, pok)
    scale = pLinv.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1.0)
    assert ((Linv - pLinv).abs() / scale).max() < 1e-4
    assert ((d - pd).abs() / pd.abs().clamp_min(1.0)).max() < 1e-4

    class Shared(batched_ldl.LdlInverseKernel):
        def variant(self, n):
            return ()

    sLinv, sd, sok = Shared()(K, signs, 1e-13, 2e-7, True)
    assert torch.equal(ok, sok)
    assert torch.equal(Linv[ok], sLinv[ok]) and torch.equal(d[ok], sd[ok])
    # lanes with an infinite, a NaN and a huge entry, one with an infinite
    # entry mid-matrix and one whose update overflows: the rows design runs
    # them again with the full-row update, and every lane's bits agree
    mid = (n + m) // 2
    K[1, -1, 0] = K[1, 0, -1] = float("inf")
    K[2, -1, 1] = K[2, 1, -1] = float("nan")
    K[3, 0, 0], K[3, -1, 0], K[3, 0, -1] = 1e-30, 1e30, 1e30
    K[4, mid, 1] = K[4, 1, mid] = float("inf")
    K[5, mid, 0] = K[5, 0, mid] = 3e38
    got = batched_ldl.batched_ldl_inverse(K, signs)
    want = Shared()(K, signs, 1e-13, 2e-7, True)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["exp", "pow", "switch"])
def test_nonsym_kernels_hold_their_bars_on_the_card(name):
    """K1b from each source, the group kernel (csrc/megakernel_group.cu)
    and one lane per thread (csrc/megakernel.cu), on chip_smoke.py's
    batches at NONSYM_B = 4096 held to its plain version by chip_smoke.py's
    NONSYM_BARS; BatchSolver.solve at 256 lanes launches the source
    `_cuda.variant_of` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m gpu)")
    import chip_smoke as cs
    B = cs.NONSYM_B
    cone = ctt.PowerConeT(0.6) if name == "pow" else ctt.ExponentialConeT()
    make = (bench_data.make_pow_batch if name == "pow"
            else bench_data.make_exp_batch)
    st = (ctt.Settings(min_switch_step_length=cs.SWITCH)
          if name == "switch" else ctt.Settings())
    P, q, A, b = (a[:B] for a in make(max(cs.NONSYM_THROUGHPUT)
                                      if name != "pow" else B))
    bs = ctt.BatchSolver([ctt.NonnegativeConeT(2), cone], 3, st)
    spec = bs._mega_fn.spec
    _, flats = megakernel.prepare(P, q, A, b, spec, "cuda")
    pv, pi = megakernel_ref.mega_solve_plain(*flats, spec, B)
    p = cs.outputs(pv, pi, spec)
    for group in (0, 1):
        kern = cs.pinned_kernel(group)
        k = cs.outputs(*kern(*flats, spec, B), spec)
        r = cs.readings(k, p, P, q, A, b)
        assert not cs.violations(r, cs.NONSYM_BARS[name], B), cs.describe(r)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variant = _cuda.variant_of(_cuda.shape_of(spec), 256, sms)
    before = (_cuda.megakernel.launches, _cuda.megakernel.group_launches)
    bs.solve(*(a[:256] for a in (P, q, A, b)))
    assert _cuda.megakernel.launches == before[0] + 1
    assert _cuda.megakernel.group_launches == before[1] + variant[7]
