"""The port's BASELINE.md runner (`baseline_torch.py`) and its generators
(`clarabel_tpu_torch/bench_data.py`) on the CPU:

* the six generator copies give `benchmarks/configs.py`'s arrays bit for
  bit, at the runner's full scale, and the same cones;
* two `--quick` rows of the runner (the CVXQP1-style file through the
  port's QPS reader, and the robust least-squares SOCP) against the
  reference `Solver`'s outputs in `tests/torch_fixtures/long.npz`, under
  the North star's bars (`tests/test_megakernel.py:66-95`): status equal,
  iterations within 4, x within 1e-6 of the reference relative to
  max(1, |x|inf), the objective within 1e-6 relative to max(1, |obj|),
  and the true-KKT residuals of the port's own output below 1e-7; and its
  last line, one JSON object with each row's status, iterations and ms.
  As `chip_smoke.py` [12] and [16] do, a bar that the reference fails
  against itself under three 1e-15 changes of q (the fixture's
  `spread_*`) measures rounding and is not held: on the robust
  least-squares SOCP (P = 0) the 1e-8 stopping point pins x only to
  5.0e-5 at this scale, and the reference's own true-KKT residual reads
  up to 4.95e-7 there, so its x and true KKT are not held
  (DEVIATIONS.md #19); the test checks that this is the only such row;
* the runner reads the committed `.qps` files and never writes them.

The whole runner at full scale is for the card (`chip_smoke.py` [16]).
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

from benchmarks import configs
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.interop import cone_to_tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import baseline_torch  # noqa: E402

FIX = np.load(os.path.join(ROOT, "tests", "torch_fixtures", "long.npz"))
TOL, IT_TOL, KKT_TOL = 1e-6, 4, 1e-7

GENERATORS = {
    "markowitz_qp": {"n_assets": 200},
    "cvxqp_style": {"n": 200},
    "aug2d_style": {"grid": 10},
    "robust_least_squares_socp": {"m": 2000, "n": 500},
    "batched_socp": {"B": 4096, "n": 6},
    "maxcut_sdp": {"nv": 60},
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_copies_are_bit_for_bit(name):
    kw = GENERATORS[name]
    got, ref = getattr(bench_data, name)(**kw), getattr(configs, name)(**kw)
    if name == "batched_socp":
        (got, gcones), (ref, rcones) = got, ref
    else:
        got, gcones = got[:4], got[4]
        ref, rcones = ref[:4], ref[4]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert [cone_to_tuple(c) for c in gcones] == \
        [cone_to_tuple(c) for c in rcones]


def _rows():
    return {key: (name, gen) for key, name, gen
            in baseline_torch.single_rows(0.25)}


def true_kkt(P, q, A, b, sol):
    U = np.triu(P)
    Pf = U + np.triu(U, 1).T
    return (np.linalg.norm(A @ sol.x + sol.s - b),
            np.linalg.norm(Pf @ sol.x + q + A.T @ sol.z))


@pytest.mark.parametrize("key", ["cvxqp1", "robust_ls"])
def test_quick_rows_match_reference(key):
    name, gen = _rows()[key]
    sol, t, (P, q, A, b, _) = baseline_torch.run_single(name, gen, "cpu",
                                                        repeats=1)
    ref = {k: FIX[f"quick_{key}_{k}"] for k in ("status", "iterations",
                                                 "obj_val", "x")}
    assert int(sol.status) == int(ref["status"]) == 1
    assert abs(sol.iterations - int(ref["iterations"])) <= IT_TOL
    rounding = rounding_bars("quick", key)
    assert rounding == ({"x", "true KKT"} if key == "robust_ls" else set())
    if "x" not in rounding:
        assert np.abs(sol.x - ref["x"]).max() <= TOL * max(
            1.0, np.abs(ref["x"]).max())
    assert abs(sol.obj_val - float(ref["obj_val"])) <= TOL * max(
        1.0, abs(float(ref["obj_val"])))
    rp, rd = true_kkt(P, q, A, b, sol)
    if "true KKT" not in rounding:
        assert rp < KKT_TOL and rd < KKT_TOL, (rp, rd)
    assert t > 0


def rounding_bars(prefix, key):
    """The bars the reference fails against itself on a row."""
    return ({"x"} if float(FIX[f"spread_{prefix}_{key}_dx"]) > TOL
            else set()) | ({"true KKT"} if float(
                FIX[f"spread_{prefix}_{key}_kkt"]) >= KKT_TOL else set())


def test_only_robust_ls_has_rounding_bars():
    keys = [k for k, _, _ in baseline_torch.single_rows(1.0)]
    for prefix in ("quick", "row"):
        assert {k for k in keys if rounding_bars(prefix, k)} == \
            {"robust_ls"}


def _digests():
    return {f: hashlib.sha256(open(os.path.join(
        baseline_torch.DATA_DIR, f), "rb").read()).hexdigest()
        for f in baseline_torch.QPS_FILES}


def test_runner_last_line_and_files_untouched(capsys):
    before = _digests()
    baseline_torch.main(["--device", "cpu", "--quick", "--rows",
                         "cvxqp1,robust_ls"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert _digests() == before
    assert lines[0].startswith("qps CVXQP1-style") and "status=SOLVED" in \
        lines[0]
    assert lines[1].startswith("robust LS SOCP")
    last = json.loads(lines[-1])
    assert sorted(last["rows"]) == ["cvxqp1", "robust_ls"]
    for row in last["rows"].values():
        assert row["status"] == "SOLVED" and row["ms"] > 0
    assert last["device"] == "cpu" and last["scale"] == 0.25
