"""The port's sparse and structured KKT pieces against the JAX package's,
on the CPU, on seeded data and a seeded scaling state:

* `linalg/matops.py`: the COO products, column and row norms and
  scalings, and the sparse Ruiz equilibration (`ipm/equilibration.py`);
* the assembly maps of a block-arrow and of a nested plan
  (`kkt/assembly_maps.py`, `kkt/assembly_maps_nd.py`), index for index;
* `cones/ops.py` `hs_coords` (exactly), `hs_flat_values` and
  `soc_rank2_uv` on a layout with small and rank-2 SOCs, an exponential
  and a low-rank generalized power cone;
* factor-and-apply: the block-arrow factor from the maps, and the same
  with the rank-2 SMW correction (`kkt/socrank.py`); the multifrontal
  factor from the nested maps and both structured factors on dense data
  are in `tests/test_torch_sparse_kkt_mf.py` (each file within seconds).

Index maps must be equal; every value within 1e-12 (float64), relative to
the largest entry where the scale is not 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu.cones import ops as rops
from clarabel_tpu.cones.layout import ConeLayout as RefLayout
from clarabel_tpu.ipm.equilibration import ruiz_equilibrate as ref_ruiz
from clarabel_tpu.kkt import assembly_maps as ram
from clarabel_tpu.kkt import assembly_maps_nd as ramnd
from clarabel_tpu.kkt import blockarrow as rba
from clarabel_tpu.kkt import multifrontal as rmf
from clarabel_tpu.kkt import socrank as rsoc
from clarabel_tpu.linalg import matops as rmat
from clarabel_tpu import structure as rstruct
from clarabel_tpu import structure_nd as rstruct_nd
from clarabel_tpu_torch.cones import ops as pops
from clarabel_tpu_torch.cones.layout import ConeLayout as PortLayout
from clarabel_tpu_torch.interop import cone_from_tuple, cone_to_tuple
from clarabel_tpu_torch.ipm.equilibration import ruiz_equilibrate
from clarabel_tpu_torch.kkt import assembly_maps as pam
from clarabel_tpu_torch.kkt import assembly_maps_nd as pamnd
from clarabel_tpu_torch.kkt import blockarrow as pba
from clarabel_tpu_torch.kkt import multifrontal as pmf
from clarabel_tpu_torch.kkt import socrank as psoc
from clarabel_tpu_torch.linalg import matops as pmat
from clarabel_tpu_torch import structure as pstruct
from clarabel_tpu_torch import structure_nd as pstruct_nd

from conic_check import interior_dual_point, interior_point
from test_blockarrow_backend import banded_qp
from test_multifrontal import grid_qp
from test_soc_rank2 import robust_ls_banded

TOL = 1e-12
SRK = rops.SOC_RANK2_MIN_DIM


def t(x):
    """A reference array as a port tensor with the lane axis (B = 1)."""
    return torch.from_numpy(np.array(x, dtype=np.float64))[None]


def close(got, want, scale=None):
    got = got.detach().numpy()[0] if torch.is_tensor(got) else got
    want = np.asarray(want)
    s = max(1.0, np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * s)


def port_cones(cones):
    return [cone_from_tuple(cone_to_tuple(c)) for c in cones]


def ref_state(ref_lay, cones, seed, strategy=0):
    """A scaling state at interior s, z (the reference's), and the same
    state as the port holds it (each field with the lane axis)."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([interior_point(c, rng) for c in cones])
    z = np.concatenate([interior_dual_point(c, rng) for c in cones])
    st, ok = jax.jit(lambda s_, z_: rops.update_scaling(
        ref_lay, None, s_, z_, jnp.asarray(0.7), strategy))(
            jnp.asarray(s), jnp.asarray(z))
    assert bool(ok)
    port = {g: {k: t(v) for k, v in fields.items()}
            for g, fields in st.items()}
    return st, port


def _sparse(seed, m=40, n=25, density=0.15):
    return sp.random(m, n, density=density, random_state=seed,
                     format="coo") * 3.0


def test_matops_products_and_norms():
    M = _sparse(1)
    R, P = rmat.make_sparse_coo(M), pmat.make_sparse_coo(M)
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal(25), rng.standard_normal(40)
    X, Y = rng.standard_normal((25, 2)), rng.standard_normal((40, 2))
    close(pmat.mv(P, t(x)), rmat.mv(R, jnp.asarray(x)))
    close(pmat.mv(P, t(X)), rmat.mv(R, jnp.asarray(X)))
    close(pmat.rmv(P, t(y)), rmat.rmv(R, jnp.asarray(y)))
    close(pmat.rmv(P, t(Y)), rmat.rmv(R, jnp.asarray(Y)))
    close(pmat.col_abs_max(P), rmat.col_abs_max(R))
    close(pmat.row_abs_max(P), rmat.row_abs_max(R))
    close(pmat.mean_col_abs_max(P), rmat.mean_col_abs_max(R))
    l, r = rng.uniform(0.5, 2, 40), rng.uniform(0.5, 2, 25)
    close(pmat.scale_lr(P, t(l), t(r)).vals,
          rmat.scale_lr(R, jnp.asarray(l), jnp.asarray(r)).vals)
    close(pmat.scalar_mul(P, torch.tensor([0.3], dtype=torch.float64)).vals,
          rmat.scalar_mul(R, 0.3).vals)
    # the dense branch is the plain tensor product
    Md = M.toarray()
    close(pmat.mv(t(Md), t(x)), Md @ x)


def test_fixed_order_sums():
    """SegmentSum adds each destination's entries in their source order:
    the same bits as a sequential loop."""
    rng = np.random.default_rng(5)
    dest = rng.integers(-2, 12, 300)
    src = rng.standard_normal(300)
    want = np.zeros(10)
    for d, v in zip(dest, src):
        if 0 <= d < 10:
            want[d] += v
    got = pmat.SegmentSum(dest, 10)(t(src))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_sparse_equilibration():
    P, q, A, b, cones = banded_qp(grid=20)
    cones = cones + [ct.SecondOrderConeT(3)]
    A = np.vstack([A, -np.eye(3, A.shape[1])])
    b = np.concatenate([b, [2.0, 0.0, 0.0]])
    ref_lay = RefLayout(cones)
    port_lay = PortLayout(port_cones(cones))
    Ps, As = sp.coo_matrix(P), sp.coo_matrix(A)
    rP, rA, rq, rb, req = ref_ruiz(
        ref_lay, ct.Settings(), rmat.make_sparse_coo(Ps),
        rmat.make_sparse_coo(As), jnp.asarray(q), jnp.asarray(b))
    pP, pA, pq, pb, peq = ruiz_equilibrate(
        port_lay, ctt.Settings(), pmat.make_sparse_coo(Ps),
        pmat.make_sparse_coo(As), t(q), t(b))
    for got, want in ((pP.vals, rP.vals), (pA.vals, rA.vals), (pq, rq),
                      (pb, rb), (peq.d, req.d), (peq.e, req.e)):
        close(got, want)
    close(peq.c, req.c)


def _mixed_layout():
    """Cones with every Hs form: nn, a small SOC, a rank-2 SOC, an
    exponential cone and a low-rank generalized power cone."""
    return [ct.NonnegativeConeT(4), ct.SecondOrderConeT(3),
            ct.SecondOrderConeT(SRK + 2), ct.ExponentialConeT(),
            ct.GenPowerConeT([0.4, 0.6], SRK)]


def test_hs_values_coords_and_lowrank_columns():
    cones = _mixed_layout()
    ref_lay, port_lay = RefLayout(cones), PortLayout(port_cones(cones))
    st, pst = ref_state(ref_lay, cones, seed=3, strategy=1)
    like = torch.zeros((1, 1), dtype=torch.float64)
    n = 7
    for srk in (None, SRK):
        rr, rc = rops.hs_coords(ref_lay, n, soc_rank2_min_dim=srk)
        pr, pc = pops.hs_coords(port_lay, n, soc_rank2_min_dim=srk)
        np.testing.assert_array_equal(pr, rr)
        np.testing.assert_array_equal(pc, rc)
        close(pops.hs_flat_values(port_lay, pst, like, soc_rank2_min_dim=srk),
              jax.jit(lambda st_: rops.hs_flat_values(
                  ref_lay, st_, jnp.float64, soc_rank2_min_dim=srk))(st))
    U, signs = pops.soc_rank2_uv(port_lay, pst, n, like, soc_rank2_min_dim=SRK)
    rsigns = rops.soc_rank2_uv(ref_lay, st, n, jnp.float64,
                               soc_rank2_min_dim=SRK)[1]
    rU = jax.jit(lambda st_: rops.soc_rank2_uv(
        ref_lay, st_, n, jnp.float64, soc_rank2_min_dim=SRK)[0])(st)
    np.testing.assert_array_equal(signs, rsigns)
    close(U, rU)
    assert pops.soc_rank2_uv(port_lay, pst, n, like)[0] is None


def _setup(P, A, cones, srk=None, nested=False):
    """Both packages' plans and maps for a problem; returns (ref maps,
    port maps, P COO, A COO)."""
    Ps = sp.triu(sp.coo_matrix(P))
    Ps = (Ps + sp.triu(Ps, 1).T).tocoo()
    As = sp.coo_matrix(A)
    n, m = P.shape[0], A.shape[0]
    pats = (((Ps.row, Ps.col), (n, n)), ((As.row, As.col), (m, n)))
    ref_lay, port_lay = RefLayout(cones), PortLayout(port_cones(cones))
    coords = ((Ps.row, Ps.col), (As.row, As.col))
    if nested:
        rplan = rstruct_nd.analyze_nested_dissection(*pats, ref_lay)
        pplan = pstruct_nd.analyze_nested_dissection(*pats, port_lay)
        rmaps = ramnd.build_nested_assembly_maps(*coords, ref_lay, rplan)
        pmaps = pamnd.build_nested_assembly_maps(*coords, port_lay, pplan)
    else:
        rplan = rstruct.analyze_block_arrow(*pats, ref_lay,
                                            soc_rank2_min_dim=srk)
        pplan = pstruct.analyze_block_arrow(*pats, port_lay,
                                            soc_rank2_min_dim=srk)
        rmaps = ram.build_assembly_maps(*coords, ref_lay, rplan,
                                        soc_rank2_min_dim=srk)
        pmaps = pam.build_assembly_maps(*coords, port_lay, pplan,
                                        soc_rank2_min_dim=srk)
    return rmaps, pmaps, Ps, As, ref_lay, port_lay


def _same_maps(rmaps, pmaps):
    for k in ("dest", "pad_diag_dest", "diag_dest", "diag_signs"):
        np.testing.assert_array_equal(getattr(pmaps, k), getattr(rmaps, k),
                                      err_msg=k)
    assert pmaps.key == rmaps.key
    assert pmaps.buf_size == rmaps.buf_size


def _vals(Ps, As):
    return (Ps.data, As.data)


@pytest.mark.parametrize("case", ["blockarrow", "rank2"])
def test_maps_factor_and_apply(case):
    """The maps index for index, then the factor from the maps applied to
    two right-hand sides, within 1e-12."""
    if case == "blockarrow":
        P, _, A, _, cones = banded_qp(grid=20)
        srk, nested = None, False
    elif case == "rank2":
        # P = I keeps the blocks' LDL well conditioned (with P = 0 its
        # multipliers grow like |A|/eps and rounding alone moves the
        # apply by 1e-5 in both packages)
        _, _, A, _, cones, _, _ = robust_ls_banded(120, 40)
        A = A.toarray()
        P = np.eye(A.shape[1])
        srk, nested = SRK, False
    else:
        P, _, A, _, cones = grid_qp(8)
        srk, nested = None, True
    rmaps, pmaps, Ps, As, ref_lay, port_lay = _setup(P, A, cones, srk,
                                                     nested)
    _same_maps(rmaps, pmaps)
    st, pst = ref_state(ref_lay, cones, seed=7)
    n, N = P.shape[0], P.shape[0] + A.shape[0]
    rs, ps = ct.Settings(), ctt.Settings()
    like = torch.zeros((1, 1), dtype=torch.float64)
    phs = pops.hs_flat_values(port_lay, pst, like, soc_rank2_min_dim=srk)
    rhs = np.random.default_rng(11).standard_normal((N, 2))
    pargs = (t(Ps.data), t(As.data), phs)

    def ref(st, Pv, Av, r):
        """The reference's factor and apply, as one jitted function."""
        hs = rops.hs_flat_values(ref_lay, st, jnp.float64,
                                 soc_rank2_min_dim=srk)
        if nested:
            fac = ramnd.factor_from_nested_maps(rmaps, Pv, Av, hs, rs,
                                                "float64")
            return fac.ok, rmf._mf_apply(fac, rmaps.plan, r)
        fac = ram.factor_from_maps(rmaps, Pv, Av, hs, rs, "float64")
        apply = lambda v: rba._ba_apply(fac, rmaps.plan, v)  # noqa: E731
        ok = fac.ok
        if srk is not None:
            U, sg = rops.soc_rank2_uv(ref_lay, st, n, jnp.float64,
                                      soc_rank2_min_dim=srk)
            apply, okc = rsoc.wrap_apply_smw(apply, U, sg, rs)
            ok = ok & okc
        return ok, apply(r)

    rok, want = jax.jit(ref)(st, jnp.asarray(Ps.data), jnp.asarray(As.data),
                             jnp.asarray(rhs))
    assert bool(rok)
    if nested:
        pfac = pamnd.factor_from_nested_maps(pmaps, *pargs, ps, "float64")
        port_apply = lambda r: pmf._mf_apply(pfac, pmaps.plan, r)  # noqa
        pok = pfac.ok
    else:
        pfac = pam.factor_from_maps(pmaps, *pargs, ps, "float64")
        port_apply = lambda r: pba._ba_apply(pfac, pmaps.plan, r)  # noqa
        pok = pfac.ok
        if srk is not None:
            pU, psg = pops.soc_rank2_uv(port_lay, pst, n, like,
                                        soc_rank2_min_dim=srk)
            port_apply, okc = psoc.wrap_apply_smw(port_apply, pU, psg, ps)
            pok = pok & okc
    assert bool(pok[0])
    close(port_apply(t(rhs)), want)
    close(port_apply(t(rhs[:, 0])), want[:, 0])
