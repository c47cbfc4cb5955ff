"""The port's megakernel path on generalized power cones (K1c's plain
PyTorch version, `BatchSolver(..., kkt_backend="megakernel",
device="cpu")`) against the JAX megakernel.

The JAX megakernel's genpow body compiles for tens of minutes on the CPU,
so the comparison is against a committed fixture
(`tests/torch_fixtures/make_psd_genpow_fixtures.py genpow`): 64 lanes of
the batch of `tests/test_megakernel_nonsym.py` (`test_genpow_matches_loop`:
n=4, cones [NN(2), GenPow((0.3, 0.7), 2)]), with the JAX loop's solve
beside it.

The bars are `_compare`'s of `tests/test_megakernel_nonsym.py`: every port
status SOLVED or ALMOST_SOLVED and its SOLVED count at least the
reference's less 2; on the lanes both solve, objectives within 1e-6, x
within 5e-4 (flat optima) and iterations within 8 of the JAX megakernel's
or of the JAX loop's; the port's SOLVED lanes meet the true KKT conditions
to 1e-7.  A generalized power cone has only the dual scaling: every lane
starts and ends on the Dual strategy.
"""

import dataclasses

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.ipm import _cuda, megakernel, megakernel_ref
from clarabel_tpu_torch.parallel import batch_impl

from test_torch_megakernel_nonsym import assert_bars
from test_torch_megakernel_psd import load_fixture, port_solver

SOLVED = int(ctt.SolverStatus.SOLVED)
MEGA = ctt.Settings(kkt_backend="megakernel")
GP = [("NonnegativeConeT", 2), ("GenPowerConeT", (0.3, 0.7), 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_matches_jax_megakernel_fixture():
    cones, n, P, q, A, b, ref = load_fixture("genpow")
    bs = port_solver(cones, n)
    assert bs._mega_fn is not None
    out = bs.solve(P, q, A, b)
    assert_bars(out, ref, P, q, A, b)
    spec = bs._mega_fn.spec
    _, flats = megakernel.prepare(P, q, A, b, spec, "cpu")
    _, ints = megakernel_ref.mega_solve_plain(*flats, spec, len(q))
    assert (ints[2] == megakernel_ref.DUAL).all()


def test_every_lane_starts_on_dual():
    """With max_iter=0 the kernel's loop stops at its first check: the
    strategy it returns is the one every lane starts with."""
    P, q, A, b = bench_data.make_genpow_batch(4)
    spec = port_solver(GP, 4)._mega_fn.spec
    spec = dataclasses.replace(spec, st=spec.st.replace(max_iter=0))
    _, flats = megakernel.prepare(P, q, A, b, spec, "cpu")
    _, ints = megakernel_ref.mega_solve_plain(*flats, spec, 4)
    assert (ints[1] == 0).all() and (ints[2] == megakernel_ref.DUAL).all()


def test_eligibility_width_and_budget():
    """Widths up to 16, each cone charged 1 + w // 3 against the budget of
    16 nonsymmetric segments (clarabel_tpu/ipm/megakernel.py:158-172);
    what is not eligible resolves "auto" to a loop backend, on a card
    too."""
    st = ctt.Settings()
    cuda = torch.device("cuda")
    for cones, n, ok in (
            ([ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)], 4,
             True),
            ([ctt.GenPowerConeT((0.25,) * 4, 12)], 8, True),       # w = 16
            ([ctt.GenPowerConeT((0.25,) * 4, 14)], 8, False),      # w = 18
            ([ctt.GenPowerConeT((0.5, 0.5), 1)] * 8, 4, True),     # 8 x 2
            ([ctt.GenPowerConeT((0.5, 0.5), 1)] * 9, 4, False),    # 9 x 2
            ([ctt.GenPowerConeT((0.5, 0.5), 1)] * 4
             + [ctt.PSDTriangleConeT(3)] * 2, 4, True)):           # 8 + 8
        lay = ConeLayout(cones)
        assert megakernel.eligible(lay, st, n) == ok, cones
        assert batch_impl.resolve_backend(lay, st, n, cuda) == (
            "megakernel" if ok else "condensed")


def test_spec_and_kernel_params():
    spec = port_solver(GP, 4)._mega_fn.spec
    assert spec.gp_alphas == ((), (0.3, 0.7))
    assert _cuda.shape_of(spec) == (4, 6, 2, 1, 0, 1, 0)
    prm = _cuda._params(spec)
    assert list(prm.seg_kind) == [1, 5]
    assert list(prm.gp_d1) == [0, 2]
    assert list(prm.gp_alpha[16:18]) == [0.3, 0.7]
    assert not any(prm.gp_alpha[:16]) and not any(prm.gp_alpha[18:])
    assert not hasattr(prm, "psd_sweeps")
    both = port_solver(GP + [("PSDTriangleConeT", 2)], 4)._mega_fn.spec
    assert _cuda.shape_of(both) == (4, 9, 3, 1, 1, 1, 0)
    assert _cuda._params(both).psd_sweeps == spec.psd_sweeps == 12


def test_rescue_closes_lanes_the_kernel_leaves():
    P, q, A, b = bench_data.make_genpow_batch(8)
    cut = MEGA.replace(max_iter=8)
    alone = port_solver(GP, 4, cut).solve(P, q, A, b)
    assert (alone.status != SOLVED).sum() >= 4
    res = port_solver(GP, 4, cut, rescue="cpu",
                      rescue_settings=ctt.Settings()).solve(P, q, A, b)
    assert res.all_solved
    kept = alone.status == SOLVED
    np.testing.assert_array_equal(res.x[kept], alone.x[kept])
