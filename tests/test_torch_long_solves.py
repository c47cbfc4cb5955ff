"""The port's long solves (`clarabel_tpu_torch/api.py`, `ipm/loop.py`) on
the CPU (`device="cpu"`), against the JAX package's, as
`tests/test_chunked.py` and `tests/test_settings_paths.py:113-128` hold
the reference:

* the loop's stages: the IPM state after `run_phases(..., iter_cap=3)`
  equals the reference's after `_chunk_fn(..., 3)` within STATE_TOL (the
  committed `tests/torch_fixtures/long.npz`, `make_long_fixtures.py`);
* chunked solves (`chunk_iters` 25 and 1) and `time_limit=600` give the
  one-shot solve's bits, on the dense path and on a small sparse case of
  `sparse.npz`; a tiny limit ends MAX_TIME, ALMOST_SOLVED or SOLVED;
* checkpoint after three iterations and resume: the one-shot solve's bits,
  and the reference's resumed x within 1e-8;
* `timing=True` keeps the bits; `print_timers` prints its tree and the
  device; `profile_trace` writes a Chrome trace.

The mixed-precision verify drive (`verify_mixed`) is the drive that
`chip_smoke.py` [15] runs on the card.
"""

import json
import os
import time

import numpy as np
import pytest

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.api import _fetch
from clarabel_tpu_torch.ipm.loop import Carry

from fixtures import basic_qp_data

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = np.load(os.path.join(HERE, "torch_fixtures", "long.npz"))
CASES = {"basic_qp": {}, "verify_mixed": {"mixed_precision": True}}
STATE_TOL = 1e-10


def _problem():
    P, q, A, b, cones = basic_qp_data()
    return P, q, A, b, [ctt.NonnegativeConeT(c.dim) for c in cones]


def _solver(case, **kw):
    P, q, A, b, cones = _problem()
    return ctt.Solver(P, q, A, b, cones,
                      ctt.Settings(**CASES[case], **kw), device="cpu")


def _same_bits(a, b):
    assert int(a.status) == int(b.status)
    assert a.iterations == b.iterations
    for k in ("x", "z", "s"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.obj_val == b.obj_val


def _capped_state(solver, cap=3):
    fn = solver._solve_fn
    data, carry = fn.prepare(*solver._device_args())
    return data, fn.run_phases(data, carry, cap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_after_cap_matches_reference(case):
    _, carry = _capped_state(_solver(case))
    assert int(carry.iters[0]) == 3
    for k in Carry._fields:
        ref = FIX[f"state_{case}_{k}"]
        got = getattr(carry, k)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=STATE_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("chunk", [25, 1])
def test_chunked_solve_has_the_one_shot_bits(case, chunk):
    one = _solver(case).solve()
    s = _solver(case, time_limit=600.0)
    got = s._package_solution(
        _fetch(s._solve_chunked(time.perf_counter(), chunk_iters=chunk)), 0.0)
    _same_bits(got, one)
    _same_bits(s.solve(), one)          # time_limit=600 through solve()


@pytest.mark.parametrize("case", sorted(CASES))
def test_long_solves_match_reference(case):
    """The chunked, resumed and timed solutions against the reference's
    own (status and iterations equal, x within 1e-8)."""
    one = _solver(case).solve()
    for path in ("one_shot", "chunked", "resumed", "timed"):
        assert int(FIX[f"{path}_{case}_status"]) == int(one.status), path
        assert int(FIX[f"{path}_{case}_iterations"]) == one.iterations, path
        np.testing.assert_allclose(one.x, FIX[f"{path}_{case}_x"], rtol=0,
                                   atol=1e-8, err_msg=path)


def test_chunked_sparse_case_has_the_one_shot_bits():
    from test_torch_sparse_solver import load_case

    P, q, A, b, cones, st = load_case("dense_match")
    one = ctt.Solver(P, q, A, b, cones, st, device="cpu")
    assert one._sparse_mode
    ref = one.solve()
    for chunk in (25, 1):
        s = ctt.Solver(P, q, A, b, cones, st.replace(time_limit=600.0),
                       device="cpu")
        got = s._package_solution(
            _fetch(s._solve_chunked(time.perf_counter(), chunk_iters=chunk)),
            0.0)
        _same_bits(got, ref)
    _same_bits(s.solve(), ref)


def test_tiny_time_limit_reports_max_time_or_almost():
    s = _solver("basic_qp", time_limit=1e-12)
    out = _fetch(s._solve_chunked(time.perf_counter(), chunk_iters=1))
    assert int(out["status"]) in (int(ctt.SolverStatus.MAX_TIME),
                                  int(ctt.SolverStatus.ALMOST_SOLVED),
                                  int(ctt.SolverStatus.SOLVED))
    assert int(out["iterations"]) == 1
    assert int(s.solve().status) in (int(ctt.SolverStatus.MAX_TIME),
                                     int(ctt.SolverStatus.ALMOST_SOLVED),
                                     int(ctt.SolverStatus.SOLVED))


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_resume(case, tmp_path):
    one = _solver(case).solve()
    s = _solver(case, time_limit=600.0)
    _, carry = _capped_state(s)
    s._last_carry = carry
    path = str(tmp_path / "state.npz")
    s.save_checkpoint(path)
    with np.load(path) as f:
        assert set(f.files) == set(Carry._fields)
        assert f["x"].shape == (1, 2) and int(f["iters"][0]) == 3
    sol = s.resume_from_checkpoint(path)
    _same_bits(sol, one)
    np.testing.assert_allclose(sol.x, FIX[f"resumed_{case}_x"], rtol=0,
                               atol=1e-8)
    # the resumed solve's state is saved again
    s.save_checkpoint(path)
    with np.load(path) as f:
        assert int(f["iters"][0]) == one.iterations


def test_checkpoint_needs_a_chunked_solve(tmp_path):
    s = _solver("basic_qp")
    s.solve()
    with pytest.raises(RuntimeError, match="chunked"):
        s.save_checkpoint(str(tmp_path / "state.npz"))


def test_checkpoint_callback_sees_every_chunk():
    s = _solver("basic_qp", time_limit=600.0)
    seen = []
    s._dev_args = s._device_args()
    s._solve_chunked(time.perf_counter(), chunk_iters=2,
                     checkpoint_cb=lambda c: seen.append(int(c.iters[0])))
    # the chunk that ends on the last iteration leaves the lane UNSOLVED:
    # the next chunk's first pass finds it converged without a step
    assert seen == list(range(2, seen[-1] + 1, 2)) + [seen[-1]]
    assert seen[-1] == _solver("basic_qp").solve().iterations


@pytest.mark.parametrize("case", sorted(CASES))
def test_timed_solve_keeps_bits_and_prints_timers(case, capsys):
    one = _solver(case).solve()
    s = _solver(case, timing=True)
    sol = s.solve()
    _same_bits(sol, one)
    assert s._timers["iterations"] == sol.iterations
    assert s._timers["loop"] > 0
    s.print_timers()
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "device: cpu"
    for word in ("prepare", "IPM loop", "KKT factor", "finalize",
                 "ms/iter", "cone scaling update"):
        assert word in out, word


def test_print_timers_without_timing(capsys):
    s = _solver("basic_qp")
    s.solve()
    s.print_timers()
    out = capsys.readouterr().out
    assert "device: cpu" in out and "timing=True" in out


def test_profile_trace_writes_a_trace(tmp_path):
    s = _solver("basic_qp")
    s.solve()
    with s.profile_trace(str(tmp_path)) as prof:
        sol = s.solve()
    assert sol.status == ctt.SolverStatus.SOLVED
    assert os.path.dirname(s.last_trace) == str(tmp_path)
    with open(s.last_trace) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert len(prof.key_averages()) > 0


@pytest.mark.slow
def test_long_fixtures_regenerate():
    """The reference's states and long solves, made again live, equal the
    committed fixture (`make_long_fixtures.py`'s `long` section)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_long_fixtures",
        os.path.join(HERE, "torch_fixtures", "make_long_fixtures.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    arrays = {}
    maker.long_outputs(arrays)
    for k, v in arrays.items():
        np.testing.assert_allclose(v, FIX[k], rtol=0, atol=1e-12,
                                   err_msg=k)
