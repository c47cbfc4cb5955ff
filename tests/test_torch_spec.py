"""The port's spec layer against the JAX package: settings, status codes,
cone specs and the cone layout, the settings/cone carry-over of
`clarabel_tpu_torch.interop`, and the port's independence from JAX.

Runs on the CPU in seconds (no solver is compiled)."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import clarabel_tpu as ct
from clarabel_tpu.cones import api as ct_api
from clarabel_tpu.cones.layout import ConeLayout as RefLayout

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.cones import api as ctt_api
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.interop import cone_to_tuple, from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "clarabel_tpu_torch")

CONE_LISTS = [
    [("NonnegativeConeT", 6), ("SecondOrderConeT", 7)],
    [("ZeroConeT", 1), ("NonnegativeConeT", 7)],
    [("ZeroConeT", 1), ("NonnegativeConeT", 2), ("SecondOrderConeT", 3)],
    [("SecondOrderConeT", 3), ("SecondOrderConeT", 5),
     ("SecondOrderConeT", 9), ("NonnegativeConeT", 2)],
    [("PSDTriangleConeT", 3), ("ZeroConeT", 3), ("ExponentialConeT",),
     ("PowerConeT", 0.3), ("GenPowerConeT", (0.2, 0.8), 2)],
]


def _ref_cones(specs):
    return [getattr(ct, name)(*args) for name, *args in specs]


def _port_cones(specs):
    return [getattr(ctt, name)(*args) for name, *args in specs]


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_settings_fields_and_defaults_match():
    ref, port = _defaults(ct.Settings), _defaults(ctt.Settings)
    assert list(port) == list(ref)
    assert port == ref
    assert port["stall_detection_ratio"] == 0.99
    assert port["megakernel_two_phase"] is False
    assert port["megakernel_tf_residual"] is True


def test_settings_from_dict_and_replace():
    st = ctt.Settings.from_dict({"max_iter": 50, "tol_feas": 1e-7})
    assert st.max_iter == 50 and st.tol_feas == 1e-7
    assert st.replace(max_iter=3).max_iter == 3 and st.max_iter == 50
    with pytest.raises(ValueError):
        ctt.Settings.from_dict({"no_such_setting": 1})


def test_solver_status_values_match():
    assert {s.name: int(s) for s in ctt.SolverStatus} == \
        {s.name: int(s) for s in ct.SolverStatus}


@pytest.mark.parametrize("specs", CONE_LISTS)
def test_cone_api_matches(specs):
    ref, port = _ref_cones(specs), _port_cones(specs)
    assert [ctt_api.nvars(c) for c in port] == [ct_api.nvars(c) for c in ref]
    assert [ctt_api.cone_degree(c) for c in port] == \
        [ct_api.cone_degree(c) for c in ref]
    assert [cone_to_tuple(c) for c in ctt_api.cones_collapse(port)] == \
        [cone_to_tuple(c) for c in ct_api.cones_collapse(ref)]


@pytest.mark.parametrize("specs", CONE_LISTS)
def test_cone_layout_matches(specs):
    ref = RefLayout(_ref_cones(specs))
    port = ConeLayout(_port_cones(specs))
    assert port.m == ref.m
    assert port.degree == ref.degree
    assert port.ranges == ref.ranges
    assert port.key == ref.key
    assert list(port.groups) == list(ref.groups)
    for name, g in port.groups.items():
        assert g.kind == ref.groups[name].kind
        np.testing.assert_array_equal(g.idx, ref.groups[name].idx)


def test_cone_layout_key_tells_orders_apart():
    a = ConeLayout([ctt.PSDTriangleConeT(3), ctt.ZeroConeT(3)])
    b = ConeLayout([ctt.ZeroConeT(3), ctt.PSDTriangleConeT(3)])
    assert a.key != b.key
    assert a.key == RefLayout([ct.PSDTriangleConeT(3),
                               ct.ZeroConeT(3)]).key


def test_from_reference_carries_settings_and_cones():
    ref_st = ct.Settings(max_iter=77, tol_gap_abs=1e-9,
                         kkt_backend="megakernel")
    specs = [cone_to_tuple(c) for c in _ref_cones(CONE_LISTS[4])]
    st, cones = from_reference(dataclasses.asdict(ref_st), specs)
    assert dataclasses.asdict(st) == dataclasses.asdict(ref_st)
    assert [cone_to_tuple(c) for c in cones] == specs
    assert all(type(c).__module__.startswith("clarabel_tpu_torch")
               for c in cones)


@pytest.mark.parametrize("case", ["psd2", "genpow"])
def test_from_reference_solves_psd_and_genpow_layouts(case):
    """The reference's settings dict and cone tuples of a PSD and of a
    generalized power layout carry across, and the port's solve is the
    JAX package's (its loop solve, committed in
    tests/torch_fixtures/loop_psd_genpow.npz): same statuses, objectives
    within 1e-6 (1 + |obj|)."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import make_psd_genpow_fixtures as fx

    cones, n, P, q, A, b = fx.case_inputs(case, fx.LOOP_B)
    ref_st = ct.Settings(kkt_backend="condensed")
    specs = [cone_to_tuple(c) for c in _ref_cones(cones)]
    st, port_cones = from_reference(dataclasses.asdict(ref_st), specs)
    out = ctt.BatchSolver(port_cones, n, st, device="cpu").solve(P, q, A, b)
    f = np.load(os.path.join(ROOT, "tests", "torch_fixtures",
                             "loop_psd_genpow.npz"))
    np.testing.assert_array_equal(out.status, f[f"{case}_condensed_status"])
    want = f[f"{case}_condensed_obj_val"]
    assert (np.abs(out.obj_val - want) < 1e-6 * (1 + np.abs(want))).all()


def test_infinity_and_version():
    assert ctt.get_infinity() == 1e20
    ctt.set_infinity(1e10)
    try:
        assert ctt.get_infinity() == 1e10
    finally:
        ctt.default_infinity()
    assert ctt.get_infinity() == 1e20
    assert ctt.version() == ctt.__version__


def _port_modules():
    mods = []
    for dirpath, _, names in os.walk(PKG):
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for n in sorted(names):
            if n.endswith(".py"):
                mods.append(rel if n == "__init__.py" else f"{rel}.{n[:-3]}")
    return sorted(mods)


def test_import_loads_no_jax_and_no_reference_package():
    mods = _port_modules()
    assert "clarabel_tpu_torch.linalg.batched_ldl" in mods
    assert "clarabel_tpu_torch.ipm.loop" in mods
    assert "clarabel_tpu_torch.cones.psd" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'clarabel_tpu')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                             "bench_torch.py",
                                             "baseline_torch.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "clarabel_tpu"), (path, mod)
