"""BatchSolver of the PyTorch port: argument checking, the slice's limits,
device selection, the host-side packing around the megakernel, and (on a
card only) the CUDA kernel against its plain version.

Imports only the port, so that the card-only test runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_batch.py
"""

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref

N = 3
CONES = [ctt.NonnegativeConeT(N), ctt.SecondOrderConeT(N + 1)]


def _batch(B, seed=0):
    return bench_data.make_batch(B, N, seed)


def _solver(cones=CONES, n=N, settings=None, **kw):
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
    ctt.ExponentialConeT(), ctt.PowerConeT(0.3),
    ctt.GenPowerConeT((0.4, 0.6), 1), ctt.PSDTriangleConeT(2)])
def test_cones_outside_the_slice_raise(cone):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _solver([ctt.NonnegativeConeT(2), cone], 2)


@pytest.mark.parametrize("change", [
    {"kkt_backend": "condensed"}, {"kkt_backend": "ldl"},
    {"kkt_backend": "blockarrow"}, {"mixed_precision": True},
    {"factor_dtype": "float32"}, {"megakernel_two_phase": True},
    {"dtype": "float32"}])
def test_settings_outside_the_slice_raise(change):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _solver(settings=ctt.Settings(**change))


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"rescue": "cpu"},
                                {"rescue_settings": ctt.Settings()}])
def test_options_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _solver(**kw)


def test_layouts_outside_the_megakernel_regime():
    big = [ctt.NonnegativeConeT(4)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _solver(big, 40)
    with pytest.raises(ValueError, match="megakernel"):
        _solver(big, 40, ctt.Settings(kkt_backend="megakernel"))


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
    assert v1.shape == (spec.outd, B) and i1.shape == (2, B)


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
    assert _cuda.shape_of(spec) == (N, 1 + 2 * N + 1, 3)
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
