"""The port's entry point (`clarabel_tpu_torch/entry.py`) and its bench
script (`bench_torch.py`) on the CPU.

`entry(device="cpu")` is held to the reference `entry()` of
`__graft_entry__.py` on the example batch through the committed fixture
of `tests/torch_fixtures/make_entry_fixtures.py` (its live regeneration
is marked slow): statuses equal lane for lane, and on the lanes both
solve, iterations within 4, objectives within 1e-6 and x within 1e-6 or
within the sum of both solutions' certificate radii (DEVIATIONS.md #4);
the port's true-KKT residuals below 1e-7.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from clarabel_tpu_torch import entry as port_entry

from test_torch_megakernel import assert_parity, certificate_radius

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "torch_fixtures")
KEYS = ("x", "z", "s", "status", "iterations", "obj_val", "obj_val_dual")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_outputs():
    fn, args = port_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.float64
               for a in args)
    out = fn(*args)
    return [a.numpy() for a in args], {k: out[k].numpy() for k in KEYS}


def _assert_entry_parity(args, out, ref):
    P, q, A, b = args
    np.testing.assert_array_equal(out["status"], ref["status"])
    radius = (certificate_radius(P, out["obj_val"] - out["obj_val_dual"])
              + certificate_radius(P, ref["obj_val"] - ref["obj_val_dual"]))
    assert_parity(out, ref, P, q, A, b, x_radius=radius)


def test_entry_matches_the_reference_fixture():
    ref = dict(np.load(os.path.join(FIXTURES, "entry.npz")))
    args, out = _port_outputs()
    # the same example batch as the reference's `_example_batch()`
    for name, a in zip("PqAb", args):
        np.testing.assert_array_equal(a, ref[name])
    assert out["x"].shape == (4, port_entry.N)
    _assert_entry_parity(args, out, ref)


@pytest.mark.slow
def test_entry_fixture_regenerates():
    maker = _load(os.path.join(FIXTURES, "make_entry_fixtures.py"),
                  "make_entry_fixtures")
    ref = maker.reference_outputs()
    old = np.load(os.path.join(FIXTURES, "entry.npz"))
    for k in ("status", "iterations"):
        np.testing.assert_array_equal(ref[k], old[k])
    np.testing.assert_allclose(ref["x"], old["x"], rtol=0, atol=1e-12)
    args, out = _port_outputs()
    _assert_entry_parity(args, out, ref)


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_entry.entry()


def test_bench_torch_prints_one_json_line(capsys):
    """`bench_torch.py --device cpu` at a tiny B prints one JSON line with
    `bench.py`'s keys, counting SOLVED lanes only."""
    bench = _load(os.path.join(ROOT, "bench_torch.py"), "bench_torch")
    bench.main(["--device", "cpu", "--batch", "16", "--batch-mid", "0",
                "--batch-big", "0", "--batch-xl", "0", "--repeats", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1
    r = json.loads(lines[0])
    for k in ("metric", "value", "unit", "batch", "solved", "wall_s",
              "mean_iters", "b_scaling", "qp_eq_zero_cone",
              "exp_cone_batched", "psd_cone_batched", "genpow_cone_batched",
              "kernel_solves_per_sec", "card", "device"):
        assert k in r, k
    assert "vs_baseline" not in r
    assert r["metric"] == "batched_socp_throughput_n6"
    assert r["b_scaling"]["16"]["solved"] == r["solved"] <= 16
    assert r["value"] == pytest.approx(r["solved"] / r["wall_s"], rel=1e-12)
    for k in ("exp_cone_batched", "psd_cone_batched", "genpow_cone_batched"):
        assert 0 < r[k]["solved"] <= 16
    assert r["kernel_solves_per_sec"] is None and r["device"] == "cpu"
