"""The frozen roofline arithmetic reproduces the figures PERF.md quotes."""

import pytest

from portbench import arith


@pytest.mark.parametrize("N,ms", [(19, 0.0550), (79, 0.7851), (80, 0.7825)])
def test_k2_bound_at_65536(N, ms):
    bound, by, _, _ = arith.k2_bound_ms(N, 65536)
    assert round(bound, 4) == ms
    assert by == "bytes"


def test_k2_bound_grows_with_lanes():
    one = arith.k2_bound_ms(79, 16384)[0]
    assert round(one, 4) == 0.1963
    assert arith.k2_bound_ms(79, 16 * 16384)[0] == pytest.approx(16 * one,
                                                                 rel=1e-3)


def test_k2_ops_closed_form():
    for N in (5, 19, 79):
        f = sum(2 * r + r * (r + 1) for r in range(N))
        assert arith.k2_ops(N) == f + (N ** 3 - N) // 3


def test_flops_per_iteration_bench_shape():
    segs = (("nn", 0, 6), ("soc", 6, 13))
    assert arith.flops_per_iteration(6, 13, segs, 0) == 4565
    assert arith.flops_per_iteration(6, 13, segs, 1) > 4565
