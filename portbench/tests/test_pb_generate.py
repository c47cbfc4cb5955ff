"""The generator draws the bench family's distribution
(`bench_data.make_batch`'s), the same arrays for a seed, and distinct
batches for every (seed, batch)."""

import json
import os

import numpy as np
import pytest

from clarabel_tpu_torch import bench_data
from portbench import harness
from portbench.generators import socp_box_ball

ROOT = harness.ROOT


@pytest.mark.parametrize("n", [6, 26])
def test_family_and_distribution(n):
    B = 4096
    P, q, A, b = socp_box_ball.make_pool(B, n, 1, 12345, "cpu")[0]
    rP, rq, rA, rb = bench_data.make_batch(B, n, seed=0)
    np.testing.assert_array_equal(A, rA)
    assert P.shape == rP.shape and q.shape == rq.shape and b.shape == rb.shape
    np.testing.assert_array_equal(P, np.swapaxes(P, 1, 2))
    assert (np.linalg.eigvalsh(P) >= 0.5 - 1e-12).all()
    np.testing.assert_array_equal(b[:, n + 1:], 0.0)
    assert ((b[:, :n] >= 0.5) & (b[:, :n] <= 1.5)).all()
    assert ((b[:, n] >= 1.0) & (b[:, n] <= 2.0)).all()
    # moments against the original's draws, within 6 standard errors:
    # E diag(P) = 1.5, E P_ij = 0 off it, q ~ N(0, 1), ub ~ U(0.5, 1.5)
    pairs = ((P, rP), (np.diagonal(P, 0, 1, 2), np.diagonal(rP, 0, 1, 2)),
             (q, rq), (b[:, :n], rb[:, :n]))
    for got, want in pairs:
        se = want.std() * np.sqrt(2.0 / want.size)
        assert abs(got.mean() - want.mean()) < 6 * se
        assert abs(got.std() - want.std()) < 6 * se + 0.02 * want.std()


@pytest.mark.parametrize("batch", [32, 65])
def test_pool_is_distinct_and_seeded(batch):
    c = harness.load_cell(ROOT, "socp_n6.b131072")
    c.traffic.update(batch=batch, pool=3)
    seed = 2 ** 31 + 12345          # past 32 signed bits
    pool = harness.make_pool(ROOT, c, seed, "cpu")
    again = harness.make_pool(ROOT, c, seed, "cpu")
    other = harness.make_pool(ROOT, c, seed + 1, "cpu")
    assert len(pool) == 3
    for k, batch in enumerate(pool):
        for a, b in zip(batch, again[k]):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(batch[1], other[k][1])
        for j in range(k):
            assert not np.array_equal(batch[1], pool[j][1])


def test_negative_seed_draws():
    c = harness.load_cell(ROOT, "socp_n6.b131072")
    c.traffic.update(batch=4)
    assert len(harness.make_pool(ROOT, c, -5, "cpu")) == c.traffic["pool"]


def test_configs_name_their_parts():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cfg in bench["configs"]:
        data = json.load(open(os.path.join(ROOT, cfg["file"])))
        for kind, key in (("generators", "generator"),
                          ("references", "reference")):
            assert os.path.exists(os.path.join(
                ROOT, "portbench", kind, data[key] + ".py"))
        assert sum(d for _, d in data["cones"]) == data["m"]
