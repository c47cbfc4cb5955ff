"""Parity of the port's batched loop solver (`clarabel_tpu_torch.ipm.loop`)
with the JAX package's `jax.vmap(build_solve(...))` on the CPU, for the four
settings of `tests/torch_fixtures/make_loop_fixtures.py`: the dense `ldl`
backend in float64, `condensed`, `Settings.throughput()` (float32, the K2
route: the port runs it with use_pallas=True, whose plain version runs on
the CPU) and `ldl` with mixed precision (K2 in the first phase).

The reference compiles for 10-25 s per setting on the CPU, so each live
comparison at n=2 (the 16 lanes of tests/test_torch_megakernel.py, one of
them primal infeasible) has a file of its own: ldl here, the others in
test_torch_loop_{condensed,throughput,mixed}.py.  The bench shape and a
layout with four SOCs of three sizes (bucketed, padded with the sentinel m)
are held against the committed fixtures of make_loop_fixtures.py.

Bars, float64 paths (ldl, condensed, mixed; the repository's,
`tests/test_megakernel.py:73-95`): statuses equal lane for lane; on the
lanes both solve, iterations within 4, objectives within 1e-6 and x within
1e-6 or, on the fixtures, within the sum of both solutions' certificate
radii (clarabel_tpu_torch/DEVIATIONS.md #4); the port's true-KKT residuals
below 1e-7 on its SOLVED lanes.  On the fixtures the dense ldl backend ends
a few lanes at its accuracy floor, where rounding alone decides between
SOLVED and ALMOST_SOLVED: `BARS_AT_THE_FLOOR` (DEVIATIONS.md #8).

Bars, float32 (throughput): SOLVED counts within 1 lane; on the lanes both
solve, objectives within 1e-4 relative, iterations within 4 and x within
`X_F32` (DEVIATIONS.md #9); the port's true-KKT residuals below 1e-4 on its
SOLVED lanes.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax

import clarabel_tpu as ct
from clarabel_tpu.cones.layout import ConeLayout as RefLayout
from clarabel_tpu.ipm.loop import build_solve as ref_build_solve

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.ipm import loop
from clarabel_tpu_torch.linalg import batched_ldl

from test_torch_megakernel import (CONES, N, _batch, assert_parity,
                                   certificate_radius)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
SOLVED = int(ct.SolverStatus.SOLVED)
OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual")

# (fixture, setting) -> lanes whose status may differ from the
# reference's, each SOLVED in one package and ALMOST_SOLVED in the other:
# the reference itself moves 1 (bench) and 2 (socs) lanes so under a 1e-15
# change of q (tests/torch_fixtures/reference_spread.py; DEVIATIONS.md #8)
BARS_AT_THE_FLOOR = {("bench", "ldl"): 1, ("socs", "ldl"): 2}
# float32: x on the lanes both solve (measured: 4.2e-6 live, 2.5e-4 on the
# bench fixture; a gap of 1e-5 leaves x free by up to ~6e-3 there)
X_F32, OBJ_F32, KKT_F32 = 1e-3, 1e-4, 1e-4


def fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_loop_fixtures", os.path.join(FIXTURES, "make_loop_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = fixture_script()


def live_batch():
    """The 16 live lanes of tests/test_torch_megakernel.py: the batch of
    tests/test_megakernel.py and the one with a primal infeasible lane."""
    parts = [_batch(8), _batch(8, seed=2, infeasible_lanes=(3,))]
    return tuple(np.concatenate(a) for a in zip(*parts))


def ref_solve(cones, n, settings, P, q, A, b):
    fn = jax.jit(jax.vmap(ref_build_solve(RefLayout(cones), settings, n,
                                          p_nonzero=True)))
    out = jax.device_get(fn(P, q, A, b))
    return {k: np.asarray(out[k]) for k in OUT_KEYS}


def port_solve(cones, n, settings, P, q, A, b):
    fn = loop.build_solve(ConeLayout(cones), settings, n, p_nonzero=True)
    out = fn(*(torch.from_numpy(np.asarray(a, np.float64))
               for a in (P, q, A, b)))
    return {k: out[k].numpy() for k in OUT_KEYS}


def port_cones(ref_cones):
    return [getattr(ctt, type(c).__name__)(c.dim) for c in ref_cones]


def port_settings(name):
    """The port runs the float32 settings on the K2 route."""
    extra = ({"use_pallas": True} if name in ("throughput", "mixed")
             else {})
    return SCRIPT.make_settings(ctt, name, **extra)


def true_kkt(out, P, q, A, b, lanes):
    x, z, s = out["x"][lanes], out["z"][lanes], out["s"][lanes]
    P, q, A, b = P[lanes], q[lanes], A[lanes], b[lanes]
    rp = np.linalg.norm(np.einsum("bij,bj->bi", A, x) + s - b, axis=1)
    rd = np.linalg.norm(np.einsum("bij,bj->bi", P, x) + q
                        + np.einsum("bji,bj->bi", A, z), axis=1)
    return np.maximum(rp, rd)


def assert_statuses(out, ref, may_differ=0):
    """Statuses equal but on at most `may_differ` lanes, each of which is
    SOLVED in one package and ALMOST_SOLVED in the other.  Returns the
    mask of the lanes whose statuses are equal."""
    diff = np.nonzero(out["status"] != ref["status"])[0]
    assert len(diff) <= may_differ, (diff, out["status"][diff],
                                     ref["status"][diff])
    pair = {SOLVED, int(ct.SolverStatus.ALMOST_SOLVED)}
    for i in diff:
        assert {int(out["status"][i]), int(ref["status"][i])} == pair, i
    return out["status"] == ref["status"]


def assert_f64_parity(out, ref, data, may_differ=0, x_radius=None):
    P, q, A, b = data
    keep = assert_statuses(out, ref, may_differ)
    sub = {k: v[keep] for k, v in out.items()}
    rsub = {k: v[keep] for k, v in ref.items()}
    assert_parity(sub, rsub, *(a[keep] for a in data),
                  x_radius=None if x_radius is None else x_radius[keep])
    solved = np.nonzero(out["status"] == SOLVED)[0]
    assert (true_kkt(out, P, q, A, b, solved) < 1e-7).all()


def assert_f32_parity(out, ref, data):
    P, q, A, b = data
    solved, rsolved = out["status"] == SOLVED, ref["status"] == SOLVED
    assert abs(int(solved.sum()) - int(rsolved.sum())) <= 1
    both = solved & rsolved
    assert both.any()
    dobj = np.abs(out["obj_val"] - ref["obj_val"])[both]
    assert (dobj <= OBJ_F32 * np.maximum(1.0, np.abs(ref["obj_val"][both]))
            ).all(), dobj.max()
    assert np.abs(out["x"] - ref["x"])[both].max() <= X_F32
    dit = np.abs(out["iterations"].astype(int) - ref["iterations"])[both]
    assert dit.max() <= 4
    assert (true_kkt(out, P, q, A, b, np.nonzero(solved)[0])
            < KKT_F32).all()


def check_live(name):
    """One setting, live at n=2: the reference's vmapped loop against the
    port's batched loop."""
    data = live_batch()
    ref = ref_solve(CONES, N, SCRIPT.make_settings(ct, name), *data)
    out = port_solve(port_cones(CONES), N, port_settings(name), *data)
    if name == "throughput":
        assert_f32_parity(out, ref, data)
    else:
        assert_f64_parity(out, ref, data)
    inf = (int(ct.SolverStatus.PRIMAL_INFEASIBLE),
           int(ct.SolverStatus.ALMOST_PRIMAL_INFEASIBLE))
    assert out["status"][11] in inf and np.isnan(out["obj_val"][11])
    assert ref["status"][11] in inf


def test_matches_jax_loop_live_ldl():
    check_live("ldl")


def load_fixture(case):
    f = np.load(os.path.join(FIXTURES, f"loop_{case}.npz"))
    cones = [tuple(c) for c in json.loads(str(f["cones"]))]
    refs = {}
    for k in f.files:
        if k.startswith("ref_"):
            st, key = k[4:].split("_", 1)
            refs.setdefault(st, {})[key] = f[k]
    return cones, int(f["n"]), (f["P"], f["q"], f["A"], f["b"]), refs


@pytest.mark.parametrize("case,name", [
    (case, name) for case, names in SCRIPT.CASE_SETTINGS.items()
    for name in names])
def test_matches_jax_loop_fixture(case, name):
    cones, n, data, refs = load_fixture(case)
    ref = refs[name]
    out = port_solve([getattr(ctt, c)(d) for c, d in cones], n,
                     port_settings(name), *data)
    if name == "throughput":
        assert_f32_parity(out, ref, data)
        return
    P = data[0]
    radius = (certificate_radius(P, out["obj_val"] - out["obj_val_dual"])
              + certificate_radius(P, ref["obj_val"] - ref["obj_val_dual"]))
    assert_f64_parity(out, ref, data, BARS_AT_THE_FLOOR.get((case, name), 0),
                      x_radius=radius)


def test_batch_solver_matches_the_wide_fixture(monkeypatch):
    """The bench family at n = 26 ([NN(26), SOC(27)], N = 79: K2's wide
    rows build on the card, its plain version here) through the port's
    BatchSolver under `Settings.throughput()` against the JAX package's
    BatchSolver (`loop_wide.npz`): statuses equal but on at most one lane
    that is SOLVED in one package and ALMOST_SOLVED in the other (the
    reference itself moves lane 2 or 4 so under a 1e-7 change of q,
    `reference_spread.py wide`), and on the lanes both solve iterations
    within 4 and objectives within OBJ_F32 relative.  Every factor takes
    the K2 route at N = 79."""
    from clarabel_tpu_torch.kkt import dense

    cones, n, data, refs = load_fixture("wide")
    ref = refs["throughput"]
    widths = []

    def k2(K, *args):
        widths.append(K.shape[-1])
        return batched_ldl.batched_ldl_inverse(K, *args)

    monkeypatch.setattr(dense, "batched_ldl_inverse", k2)
    sol = ctt.BatchSolver([getattr(ctt, c)(d) for c, d in cones], n,
                          port_settings("throughput"),
                          device="cpu").solve(*data)
    assert widths and set(widths) == {79}
    out = {"status": sol.status}
    solved = assert_statuses(out, ref, may_differ=1) & (sol.status == SOLVED)
    assert solved.sum() >= 15
    dit = np.abs(sol.iterations.astype(int) - ref["iterations"])[solved]
    assert dit.max() <= 4
    dobj = np.abs(sol.obj_val - ref["obj_val"])[solved]
    assert (dobj <= OBJ_F32 * np.maximum(1.0, np.abs(ref["obj_val"][solved]))
            ).all(), dobj.max()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["bench", "socs", "wide"])
def test_loop_fixtures_regenerate(case):
    """The committed fixtures are what the JAX loop solver computes now."""
    fresh = SCRIPT.run_reference(case)
    f = np.load(os.path.join(FIXTURES, f"loop_{case}.npz"))
    assert sorted(fresh) == sorted(f.files)
    for k in f.files:
        if f[k].dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], f[k], rtol=1e-10,
                                       atol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(fresh[k], f[k])
