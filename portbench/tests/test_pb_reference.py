"""The plain reference against the port on the CPU at a small size, and
its lower-precision modes, which the control of `correct` uses."""

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from portbench import judge
from portbench.generators import socp_box_ball
from portbench.references import conic_barrier


def _problems(n, B, seed):
    return socp_box_ball.make_pool(B, n, 1, seed, "cpu")[0]


@pytest.mark.parametrize("n,B", [(6, 256), (26, 64)])
def test_reference_meets_the_port(n, B):
    P, q, A, b = _problems(n, B, 3)
    cones = [("nn", n), ("soc", n + 1)]
    x, f, ok = conic_barrier.solve(
        *(torch.from_numpy(a) for a in (P, q, A, b)), cones)
    assert bool(ok.all())
    sol = ctt.BatchSolver([ctt.NonnegativeConeT(n),
                           ctt.SecondOrderConeT(n + 1)], n,
                          device="cpu").solve(P, q, A, b)
    solved = sol.status == int(ctt.SolverStatus.SOLVED)
    assert solved.mean() > 0.95
    f_port = judge.objective(P, q, sol.x)
    gap = np.abs(f_port - f.numpy()) / np.maximum(1, np.abs(f.numpy()))
    assert gap[solved].max() < 1e-7
    # the reference's own point is feasible and at least as good
    assert conic_barrier.infeasibility(A, b, x.numpy(), cones).max() == 0.0
    assert (f.numpy() <= f_port + 1e-12 * np.maximum(1, np.abs(f_port))
            ).all()


def test_reference_converges_further_than_the_tolerance():
    P, q, A, b = (torch.from_numpy(a) for a in _problems(6, 128, 4))
    cones = [("nn", 6), ("soc", 7)]
    _, f_tight, ok = conic_barrier.solve(P, q, A, b, cones, gap=1e-13)
    _, f_loose, _ = conic_barrier.solve(P, q, A, b, cones, gap=1e-11)
    assert bool(ok.all())
    assert float(((f_tight - f_loose).abs()
                  / f_tight.abs().clamp_min(1)).max()) < 1e-11


@pytest.mark.parametrize("mode,low,high", [("float32", 1e-9, 1e-5),
                                           ("tf32", 1e-6, 1.0)])
def test_lower_precisions_read_worse(mode, low, high):
    P, q, A, b = _problems(6, 256, 5)
    cones = [("nn", 6), ("soc", 7)]
    T = [torch.from_numpy(a) for a in (P, q, A, b)]
    _, f, _ = conic_barrier.solve(*T, cones)
    xc, _, _ = conic_barrier.solve(*T, cones, mode=mode)
    gap = np.abs(judge.objective(P, q, xc.numpy()) - f.numpy()) / np.maximum(
        1, np.abs(f.numpy()))
    assert low < gap.max() < high


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      1.0 + 3 * 2 ** -11, -3.0 - 2 ** -9],
                     dtype=torch.float32)
    got = conic_barrier.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0, 1.0 + 2 ** -9,
                         -3.0 - 2 ** -9], dtype=torch.float32)
    assert torch.equal(got, want)


def test_infeasible_start_is_refused():
    P, q, A, b = (torch.from_numpy(a) for a in _problems(6, 4, 6))
    b = b.clone()
    b[0, 0] = -1.0
    with pytest.raises(ValueError):
        conic_barrier.solve(P, q, A, b, [("nn", 6), ("soc", 7)])
