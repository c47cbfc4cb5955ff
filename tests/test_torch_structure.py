"""The port's KKT structure analysis (`clarabel_tpu_torch/structure.py`,
`structure_nd.py`, `native_symbolic.py`) against the JAX package's, on the
CPU: both packages get the same patterns, and their plans must agree
array for array (`perm`, `block_idx`, `tail_idx` and the signs of a
block-arrow plan; each level's `rows_idx`, `bnd_idx`, `rows_signs` and
`up_pos` of a nested plan).  Each pattern runs once with the native
symbolic library and once with it switched off in both packages (then
only the Python bisectors race), and a pattern with no structure gives
None in both.  The binding's ordering and bisection equal the
reference's.  The runs without the library are in
`tests/test_torch_structure_nonative.py` (each file stays within seconds).
"""

import numpy as np
import pytest

import clarabel_tpu as ct
from clarabel_tpu import native_symbolic as ref_native
from clarabel_tpu import structure as ref_structure
from clarabel_tpu import structure_nd as ref_structure_nd
from clarabel_tpu.cones.layout import ConeLayout as RefLayout
from clarabel_tpu_torch import native_symbolic as port_native
from clarabel_tpu_torch import structure as port_structure
from clarabel_tpu_torch import structure_nd as port_structure_nd
from clarabel_tpu_torch.cones.layout import ConeLayout as PortLayout
from clarabel_tpu_torch.interop import cone_from_tuple, cone_to_tuple

from test_blockarrow_backend import banded_qp
from test_multifrontal import grid_qp
from test_soc_rank2 import robust_ls_banded

SRK = ct.cones.ops.SOC_RANK2_MIN_DIM


def _unstructured():
    rng = np.random.default_rng(3)
    n = 30
    F = rng.standard_normal((n, n))
    A = np.vstack([rng.standard_normal((5, n)), -np.eye(n)])
    return F @ F.T + np.eye(n), A, [ct.NonnegativeConeT(5 + n)]


def _pattern(name):
    """(P mask, A mask, reference cones) of a test pattern."""
    if name == "banded40":
        P, _, A, _, cones = banded_qp(grid=40)
    elif name == "grid8":
        P, _, A, _, cones = grid_qp(8)
    elif name == "rls240":
        P, _, A, _, cones, _, _ = robust_ls_banded(240, 80)
        P, A = P.toarray(), A.toarray()
    else:
        P, A, cones = _unstructured()
    return P != 0, A != 0, cones


def _layouts(cones):
    return (RefLayout(cones),
            PortLayout([cone_from_tuple(cone_to_tuple(c)) for c in cones]))


def set_native_mode(mode, monkeypatch):
    """Both packages with the native library ("native"), or both without
    it ("python")."""
    if mode == "python":
        monkeypatch.setattr(ref_native, "_load", lambda: None)
        monkeypatch.setattr(port_native, "_load", lambda: None)
    else:
        assert ref_native.available() and port_native.available()


def _same_ba(ref, port):
    if ref is None or port is None:
        assert ref is None and port is None
        return
    for k in ("perm", "block_idx", "tail_idx", "block_signs", "tail_signs"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)
    assert (port.n, port.m) == (ref.n, ref.m)
    assert port.key == ref.key
    assert port.flop_estimate() == ref.flop_estimate()


def _same_nd(ref, port):
    if ref is None or port is None:
        assert ref is None and port is None
        return
    assert len(port.levels) == len(ref.levels)
    for lp, lr in zip(port.levels, ref.levels):
        for k in ("rows_idx", "bnd_idx", "rows_signs", "up_pos"):
            np.testing.assert_array_equal(getattr(lp, k), getattr(lr, k),
                                          err_msg=k)
    assert port.key == ref.key
    assert port.flop_estimate() == ref.flop_estimate()


PATTERNS = ["banded40", "grid8", "rls240", "unstructured"]


def check_plans(name):
    Pm, Am, cones = _pattern(name)
    ref_lay, port_lay = _layouts(cones)
    srks = (None, SRK) if name == "rls240" else (None,)
    for srk in srks:
        _same_ba(ref_structure.analyze_block_arrow(Pm, Am, ref_lay,
                                                   soc_rank2_min_dim=srk),
                 port_structure.analyze_block_arrow(Pm, Am, port_lay,
                                                    soc_rank2_min_dim=srk))
    nd_ref = ref_structure_nd.analyze_nested_dissection(Pm, Am, ref_lay)
    nd_port = port_structure_nd.analyze_nested_dissection(Pm, Am, port_lay)
    _same_nd(nd_ref, nd_port)
    if name == "unstructured":
        assert nd_port is None
        assert port_structure.analyze_block_arrow(Pm, Am, port_lay) is None
    elif name == "grid8":
        assert nd_port is not None
        owner, pos = port_structure_nd.node_of_rows(nd_port)
        r_owner, r_pos = ref_structure_nd.node_of_rows(nd_ref)
        np.testing.assert_array_equal(owner, r_owner)
        np.testing.assert_array_equal(pos, r_pos)


@pytest.mark.parametrize("name", PATTERNS)
def test_plans_equal_the_reference(name, monkeypatch):
    set_native_mode("native", monkeypatch)
    check_plans(name)


def test_pattern_tuples_equal_masks():
    """The sparse setup passes ((rows, cols), shape) patterns: the same
    plan as from the masks."""
    Pm, Am, cones = _pattern("grid8")
    _, port_lay = _layouts(cones)
    P_pat = (np.nonzero(Pm), Pm.shape)
    A_pat = (np.nonzero(Am), Am.shape)
    _same_ba(port_structure.analyze_block_arrow(Pm, Am, port_lay),
             port_structure.analyze_block_arrow(P_pat, A_pat, port_lay))


def test_native_binding_equals_the_reference():
    """The port's ctypes binding loads the committed library read-only and
    returns what the reference's does."""
    from test_native_symbolic import random_graph

    assert port_native.available()
    for seed in range(3):
        adj = random_graph(40, 0.1, seed)
        np.testing.assert_array_equal(
            port_native.min_degree_ordering_native(adj),
            ref_native.min_degree_ordering_native(adj))
        w = list(range(1, 41))
        np.testing.assert_array_equal(
            port_native.multilevel_bisect_native(adj, w),
            ref_native.multilevel_bisect_native(adj, w))
        perm = port_native.min_degree_ordering_native(adj)
        assert port_native.symbolic_cholesky_native(adj, perm) == \
            ref_native.symbolic_cholesky_native(adj, perm)


def test_native_library_missing(monkeypatch, tmp_path):
    """Where the library is absent the binding reports it unavailable and
    builds nothing."""
    monkeypatch.setattr(port_native, "LIB_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(port_native, "_lib", None)
    assert not port_native.available()
    assert port_native.multilevel_bisect_native([{1}, {0}], [1, 1]) is None
    assert list(tmp_path.iterdir()) == []
