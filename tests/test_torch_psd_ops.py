"""The port's PSD-triangle cone operations against the JAX package.

Each ported function of `clarabel_tpu_torch/cones/psd.py`, through the
dispatchers of `cones/ops.py`, runs on seeded interior points drawn with
numpy beside its counterpart in `clarabel_tpu/cones/psd.py` and
`clarabel_tpu/cones/ops.py` (vmapped over the lanes).  Both compute in
float64 on the CPU; the bar is 1e-12 relative (to the largest entry of
the reference's output, at least 1).

The NT scaling's R and Rinv are unique only up to the SVD's column signs
and order, so the scaling is compared through R R', Rinv' Rinv and the
sorted λ; the operations that read R itself are fed the same state on
both sides.  Two layouts: exact groups (sides 2 and 3, two side-3 cones),
and five sides, which the layout buckets (a side-k cone padded into a
larger bucket side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clarabel_tpu as ct
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones import psd as jpsd
from clarabel_tpu.cones.layout import ConeLayout as JLayout
from clarabel_tpu.cones.layout import _psd_buckets as j_buckets
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones import psd as tpsd
from clarabel_tpu_torch.cones.layout import ConeLayout as TLayout
from clarabel_tpu_torch.cones.layout import _psd_buckets as t_buckets

RTOL = 1e-12
B = 6
LAYOUTS = {
    "exact": [("NonnegativeConeT", 2), ("PSDTriangleConeT", 2),
              ("PSDTriangleConeT", 3), ("PSDTriangleConeT", 3)],
    "bucketed": [("PSDTriangleConeT", k) for k in (2, 3, 4, 5, 6)]
    + [("NonnegativeConeT", 2)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small batched ops: one thread each, as the suite runs workers side
    by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def layouts(name):
    spec = LAYOUTS[name]
    return (JLayout([getattr(ct, c)(d) for c, d in spec]),
            TLayout([getattr(ctt, c)(d) for c, d in spec]))


def _svec(M):
    k = M.shape[-1]
    return np.stack([M[..., r, c] * (1.0 if r == c else np.sqrt(2.0))
                     for c in range(k) for r in range(c + 1)], axis=-1)


def interior(name, rng, scale=1.0):
    """(B, m) points inside every cone of the layout: nn entries in
    [0.5, 2], PSD blocks svec(M M' + I)."""
    out = []
    for c, d in LAYOUTS[name]:
        if c == "NonnegativeConeT":
            out.append(rng.uniform(0.5, 2.0, (B, d)))
        else:
            M = rng.standard_normal((B, d, d)) * scale
            out.append(_svec(M @ M.transpose(0, 2, 1) + np.eye(d)))
    return np.concatenate(out, axis=1)


def tt(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def vm(fn, *args):
    """fn over the lanes of the reference (jax.vmap)."""
    return jax.jit(jax.vmap(fn))(*args)


def scalings(name, seed=0):
    """(jax layout, port layout, s, z, the reference's state and ok, the
    port's state and ok)."""
    jl, tl = layouts(name)
    rng = np.random.default_rng(seed)
    s, z = interior(name, rng), interior(name, rng, 2.0)
    mu = np.full(B, 0.5)
    strat = np.zeros(B, np.int32)
    jst, jok = vm(lambda s_, z_, m_, st_: jops.update_scaling(
        jl, None, s_, z_, m_, st_), s, z, mu, strat)
    tst, tok = tops.update_scaling(tl, None, *tt(s, z, mu, strat))
    return jl, tl, s, z, jst, jok, tst, tok


def port_state(jst):
    """The reference's state as the port's tensors."""
    return {g: {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
            for g, st in jst.items()}


def test_svec_round_trip_and_basis():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5):
        t = n * (n + 1) // 2
        X = rng.standard_normal((B, 4, t))
        M = tpsd.svec_to_mat(torch.from_numpy(X), n)
        close(M, vm(lambda x: jpsd.svec_to_mat(x, n), X))
        close(tpsd.mat_to_svec(M, n), X)
        A = rng.standard_normal((B, 4, n, n))
        close(tpsd.mat_to_svec(torch.from_numpy(A), n),
              vm(lambda a: jpsd.mat_to_svec(a, n), A))
        close(tpsd._svec_basis(n), jpsd._svec_basis(n))


@pytest.mark.parametrize("name", ["exact", "bucketed"])
def test_nt_scaling_invariants(name):
    """R R', Rinv' Rinv and the sorted λ of the scaling agree; W'W z = s
    (the scaling's defining identity, reference tests/test_psd_cone.py)."""
    jl, tl, s, z, jst, jok, tst, tok = scalings(name)
    assert np.asarray(jok).all() and tok.all()
    for gname, g in tl.groups.items():
        if g.kind != "psd":
            continue
        jR, tR = np.asarray(jst[gname]["R"]), tst[gname]["R"].numpy()
        jRi, tRi = np.asarray(jst[gname]["Rinv"]), tst[gname]["Rinv"].numpy()
        close(tR @ tR.swapaxes(-1, -2), jR @ jR.swapaxes(-1, -2))
        close(tRi.swapaxes(-1, -2) @ tRi, jRi.swapaxes(-1, -2) @ jRi)
        close(np.sort(tst[gname]["lam"].numpy(), -1),
              np.sort(np.asarray(jst[gname]["lam"]), -1))
    # Hs z = s on every PSD row
    Hz = tops.mul_Hs(tl, tst, torch.from_numpy(z)).numpy()
    rows = np.concatenate([g.idx[g.idx < tl.m].ravel()
                           for g in tl.groups.values() if g.kind == "psd"])
    np.testing.assert_allclose(Hz[:, rows], s[:, rows], rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", ["exact", "bucketed"])
def test_hs_products_inverse_and_blocks(name):
    jl, tl, s, z, jst, _, tst, _ = scalings(name, seed=1)
    st = port_state(jst)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, tl.m))
    X = rng.standard_normal((B, tl.m, 3))
    eps = np.full(B, 1e-8)
    close(tops.mul_Hs(tl, st, *tt(x)),
          vm(lambda st_, x_: jops.mul_Hs(jl, st_, x_), jst, x))
    for j in range(X.shape[2]):     # the reference's mul_Hs takes vectors
        close(tops.mul_Hs(tl, st, *tt(X))[..., j],
              vm(lambda st_, x_: jops.mul_Hs(jl, st_, x_), jst, X[..., j]))
    close(tops.mul_Hs_inv(tl, st, *tt(X, eps)),
          vm(lambda st_, x_, e_: jops.mul_Hs_inv(jl, st_, x_, e_),
             jst, X, eps))
    like = torch.zeros((B, 1), dtype=torch.float64)
    close(tops.hs_dense(tl, st, like),
          vm(lambda st_: jops.hs_dense(jl, st_, jnp.float64), jst))
    close(tops.hs_diag(tl, st, like),
          vm(lambda st_: jops.hs_diag(jl, st_, jnp.float64), jst))
    # the inverse inverts (the port's state, exact rows only)
    y = tops.mul_Hs_inv(tl, tst, tops.mul_Hs(tl, tst, *tt(x)),
                        torch.from_numpy(eps)).numpy()
    rows = np.concatenate([g.idx[g.idx < tl.m].ravel()
                           for g in tl.groups.values() if g.kind != "zero"])
    np.testing.assert_allclose(y[:, rows], x[:, rows], rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["exact", "bucketed"])
def test_step_direction_terms(name):
    """affine_ds, combined_ds_shift and ds_from_dz_offset on the same
    state."""
    jl, tl, s, z, jst, _, _, _ = scalings(name, seed=3)
    st = port_state(jst)
    rng = np.random.default_rng(4)
    dz, ds = rng.standard_normal((2, B, tl.m))
    smu = rng.uniform(0.01, 1.0, B)
    close(tops.affine_ds(tl, st, *tt(s)),
          vm(lambda st_, s_: jops.affine_ds(jl, st_, s_), jst, s))
    close(tops.combined_ds_shift(tl, st, *tt(dz, ds, smu, z)),
          vm(lambda st_, a, b_, c, d: jops.combined_ds_shift(
              jl, st_, a, b_, c, d), jst, dz, ds, smu, z))
    close(tops.ds_from_dz_offset(tl, st, *tt(ds, z)),
          vm(lambda st_, a, b_: jops.ds_from_dz_offset(jl, st_, a, b_),
             jst, ds, z))


@pytest.mark.parametrize("name", ["exact", "bucketed"])
def test_step_length_and_barrier(name):
    jl, tl, s, z, jst, _, _, _ = scalings(name, seed=5)
    st = port_state(jst)
    rng = np.random.default_rng(6)
    dz, ds = 3.0 * rng.standard_normal((2, B, tl.m))
    amax = np.ones(B)
    want = vm(lambda st_, *a: jops.step_length(jl, st_, *a, ct.Settings()),
              jst, dz, ds, z, s, amax)
    got = tops.step_length(tl, st, *tt(dz, ds, z, s, amax), ctt.Settings())
    close(got, want)
    assert (np.asarray(want) < 1.0).any()     # some step is cut
    alpha = 0.5 * np.asarray(want)
    close(tops.compute_barrier(tl, st, *tt(z, s, dz, ds, alpha)),
          vm(lambda *a: jops.compute_barrier(jl, None, *a),
             z, s, dz, ds, alpha))
    # past the boundary the barrier is +inf on both sides
    far = np.full(B, 50.0)
    got = tops.compute_barrier(tl, st, *tt(z, s, dz, ds, far)).numpy()
    want = np.asarray(vm(lambda *a: jops.compute_barrier(jl, None, *a),
                         z, s, dz, ds, far))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("name", ["exact", "bucketed"])
def test_initial_point_ops(name):
    """Margins (also of points outside the cone), the scaled unit shift,
    unit initialization and the identity scaling."""
    jl, tl = layouts(name)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((B, tl.m))
    for pd in ("primal", "dual"):
        jm, jb = vm(lambda v_: jops.margins(jl, v_, pd), v)
        tm, tb = tops.margins(tl, torch.from_numpy(v), pd)
        close(tm, jm)
        close(tb, jb)
        a = rng.uniform(0.0, 2.0, B)
        close(tops.scaled_unit_shift(tl, *tt(v, a), pd),
              vm(lambda v_, a_: jops.scaled_unit_shift(jl, v_, a_, pd), v, a))
    jz, js = jops.unit_initialization(jl, jnp.float64)
    tz, ts = tops.unit_initialization(tl, torch.float64, B, "cpu")
    close(tz, np.broadcast_to(jz, (B, tl.m)))
    close(ts, np.broadcast_to(js, (B, tl.m)))
    jid = jops.set_identity_scaling(jl, jnp.float64)
    tid = tops.set_identity_scaling(tl, torch.float64, B, "cpu")
    for gname, g in tl.groups.items():
        for k, v_ in jid[gname].items():
            close(tid[gname][k], np.broadcast_to(v_, (B,) + v_.shape))


@pytest.mark.parametrize("sizes", [
    {2: 8, 3: 5, 4: 2, 5: 1, 7: 3, 9: 1, 12: 1},
    {2: 1, 3: 1, 4: 1, 5: 1, 6: 1},
    {3: 40, 4: 1, 10: 2, 11: 1, 30: 1}])
def test_psd_buckets_and_bucketed_groups(sizes):
    """The clustering DP (the partitions of tests/test_psd_bucketing.py)
    and the padded groups it yields."""
    by_n = {k: [None] * c for k, c in sizes.items()}
    assert t_buckets(by_n) == j_buckets(by_n)
    cones = [k for k, c in sizes.items() for _ in range(c)]
    jl = JLayout([ct.PSDTriangleConeT(k) for k in cones])
    tl = TLayout([ctt.PSDTriangleConeT(k) for k in cones])
    assert tl.key == jl.key
    for name, g in tl.groups.items():
        jg = jl.groups[name]
        np.testing.assert_array_equal(g.idx, jg.idx)
        assert g.psd_n == jg.psd_n
        if jg.true_dims is None:
            assert g.true_dims is None
        else:
            np.testing.assert_array_equal(g.true_dims, jg.true_dims)
