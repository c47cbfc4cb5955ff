"""The port's multifrontal factor from the nested assembly maps, and both
structured factors (block-arrow and multifrontal) on dense data, against
the JAX package's on the CPU: the maps index for index, factor-and-apply
within 1e-12 (float64).  The helpers and the other pieces are in
`tests/test_torch_sparse_kkt.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu.cones import ops as rops
from clarabel_tpu.cones.layout import ConeLayout as RefLayout
from clarabel_tpu.kkt import blockarrow as rba
from clarabel_tpu.kkt import multifrontal as rmf
from clarabel_tpu import structure as rstruct
from clarabel_tpu import structure_nd as rstruct_nd
from clarabel_tpu_torch.cones import ops as pops
from clarabel_tpu_torch.cones.layout import ConeLayout as PortLayout
from clarabel_tpu_torch.kkt import blockarrow as pba
from clarabel_tpu_torch.kkt import multifrontal as pmf
from clarabel_tpu_torch import structure as pstruct
from clarabel_tpu_torch import structure_nd as pstruct_nd

from test_blockarrow_backend import banded_qp
from test_multifrontal import grid_qp
from test_torch_sparse_kkt import close, port_cones, ref_state, t
from test_torch_sparse_kkt import test_maps_factor_and_apply as _maps_case


def test_nested_maps_factor_and_apply():
    _maps_case("multifrontal")


@pytest.mark.parametrize("case", ["blockarrow", "multifrontal"])
def test_structured_factors_on_dense_data(case):
    """The structured backends' dense-data factor (blocks or fronts
    gathered out of K) and apply, within 1e-12."""
    if case == "blockarrow":
        P, _, A, _, cones = banded_qp()
    else:
        P, _, A, _, cones = grid_qp(8)
    ref_lay, port_lay = RefLayout(cones), PortLayout(port_cones(cones))
    st, pst = ref_state(ref_lay, cones, seed=13)
    n, m = P.shape[0], A.shape[0]
    N = n + m
    signs = np.concatenate([np.ones(n), -np.ones(m)])
    Hs = jax.jit(lambda st_: rops.hs_dense(ref_lay, st_, jnp.float64))(st)
    pHs = pops.hs_dense(port_lay, pst, t(P))
    close(pHs, Hs)
    rs, ps = ct.Settings(), ctt.Settings()
    rhs = np.random.default_rng(17).standard_normal((N, 2))
    if case == "blockarrow":
        rplan = rstruct.analyze_block_arrow(P != 0, A != 0, ref_lay)
        pplan = pstruct.analyze_block_arrow(P != 0, A != 0, port_lay)
        def ref(H, r):
            fac = rba.assemble_and_factor_blockarrow(
                jnp.asarray(P), jnp.asarray(A), H, rplan,
                jnp.asarray(signs), rs, "float64")
            return fac.ok, rba._ba_apply(fac, rplan, r)

        pfac = pba.assemble_and_factor_blockarrow(
            t(P), t(A), pHs, pplan, torch.from_numpy(signs), ps, "float64")
        got = pba._ba_apply(pfac, pplan, t(rhs))
    else:
        rplan = rstruct_nd.analyze_nested_dissection(P != 0, A != 0, ref_lay)
        pplan = pstruct_nd.analyze_nested_dissection(P != 0, A != 0,
                                                      port_lay)

        def ref(H, r):
            fac = rmf.assemble_and_factor_multifrontal(
                jnp.asarray(P), jnp.asarray(A), H, rplan,
                jnp.asarray(signs), rs, "float64")
            return fac.ok, rmf._mf_apply(fac, rplan, r)

        pfac = pmf.assemble_and_factor_multifrontal(
            t(P), t(A), pHs, pplan, torch.from_numpy(signs), ps, "float64")
        got = pmf._mf_apply(pfac, pplan, t(rhs))
    rok, want = jax.jit(ref)(Hs, jnp.asarray(rhs))
    assert bool(rok) and bool(pfac.ok[0])
    close(got, want)
