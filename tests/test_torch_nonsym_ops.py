"""The port's exponential, power and generalized power cone operations
against the JAX package.

Each ported function of `clarabel_tpu_torch/cones/nonsymmetric.py` (and
the dispatchers of `cones/ops.py`) runs on seeded interior points, drawn
with numpy, beside its counterpart in `clarabel_tpu/cones/nonsymmetric.py`.
Both compute in float64 on the CPU; the bar is 1e-12 relative (to the
largest entry of the reference's output, at least 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clarabel_tpu.cones import nonsymmetric as jref
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JLayout
import clarabel_tpu as ct
import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.cones import nonsymmetric as tnon
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TLayout
from clarabel_tpu_torch.linalg import smallops

RTOL = 1e-12
ALPHA = 0.6
GP_ALPHA, GP_D2 = (0.2, 0.3, 0.5), 2     # a generalized power cone
B, C = 16, 2    # lanes, cones per lane


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exp_points(rng, k):
    """k interior points of the exponential cone and of its dual."""
    s2, s3 = rng.uniform(0.5, 2.0, (2, k))
    s1 = s2 * np.log(s3 / s2) - rng.uniform(0.1, 2.0, k)
    z1 = -rng.uniform(0.5, 2.0, k)
    z3 = rng.uniform(0.5, 2.0, k)
    z2 = z1 + z1 * np.log(-z3 / z1) + rng.uniform(0.1, 2.0, k)
    return np.stack([s1, s2, s3], 1), np.stack([z1, z2, z3], 1)


def pow_points(rng, k, a=ALPHA):
    """k interior points of the power cone (exponent a) and of its dual."""
    s1, s2 = rng.uniform(0.5, 2.0, (2, k))
    s3 = s1 ** a * s2 ** (1 - a) * rng.uniform(-0.9, 0.9, k)
    z1, z2 = rng.uniform(0.5, 2.0, (2, k))
    z3 = (z1 / a) ** a * (z2 / (1 - a)) ** (1 - a) * rng.uniform(-0.9, 0.9, k)
    return np.stack([s1, s2, s3], 1), np.stack([z1, z2, z3], 1)


def genpow_points(rng, k, al=GP_ALPHA, d2=GP_D2):
    """k interior points of the generalized power cone and of its dual:
    heads positive, tails inside the norm bound."""
    a = np.asarray(al)

    def point(bound_of):
        head = rng.uniform(0.5, 2.0, (k, len(a)))
        tail = rng.standard_normal((k, d2))
        tail /= np.linalg.norm(tail, axis=1, keepdims=True)
        tail *= (bound_of(head) * rng.uniform(0.0, 0.9, k))[:, None]
        return np.concatenate([head, tail], 1)

    return (point(lambda h: np.prod(h ** a, axis=1)),
            point(lambda h: np.prod((h / a) ** a, axis=1)))


def points(kind, seed=0):
    rng = np.random.default_rng(seed)
    make = {"exp": exp_points, "pow": pow_points,
            "genpow": genpow_points}[kind]
    return make(rng, B * C)


def t(x):
    """(B*C, ...) numpy -> (B, C, ...) torch."""
    return torch.from_numpy(np.array(x)).reshape((B, C) + x.shape[1:])


def flat(x):
    return x.reshape((B * C,) + tuple(x.shape[2:]))


def test_wright_omega():
    z = np.concatenate([np.linspace(1.0, 1.0 + np.pi, 40),
                        np.geomspace(1.0 + np.pi, 1e6, 40)])
    close(tnon._wright_omega(torch.from_numpy(z)), jref._wright_omega(z))


def test_chol3_solve():
    rng = np.random.default_rng(3)
    F = rng.standard_normal((B, 3, 3))
    H = F @ F.transpose(0, 2, 1) + np.eye(3)
    rhs = rng.standard_normal((B, 3, 2))
    close(smallops.chol3_solve(torch.from_numpy(H), torch.from_numpy(rhs)),
          jref.chol3_solve(H, rhs))


def test_exp_gradients_and_hessian():
    S, Z = points("exp")
    close(flat(tnon._exp_grad_primal(t(S))), jref._exp_grad_primal(S))
    g, H = tnon._exp_dual_grad_H(t(Z))
    jg, jH = jref._exp_dual_grad_H(Z)
    close(flat(g), jg)
    close(flat(H), jH)


def test_pow_gradients_and_hessian():
    S, Z = points("pow")
    a = torch.full((C,), ALPHA, dtype=torch.float64)
    ja = jnp.full((B * C,), ALPHA)
    close(flat(tnon._pow_grad_primal(t(S), a, torch.float64)),
          jref._pow_grad_primal(S, ja, np.float64))
    g, H = tnon._pow_dual_grad_H(t(Z), a)
    jg, jH = jref._pow_dual_grad_H(Z, ja)
    close(flat(g), jg)
    close(flat(H), jH)


@pytest.mark.parametrize("kind", ["exp", "pow"])
def test_primal_dual_scaling(kind):
    S, Z = points(kind, seed=1)
    if kind == "exp":
        g, H = jref._exp_dual_grad_H(Z)
        zt = jref._exp_grad_primal(S)
    else:
        ja = jnp.full((B * C,), ALPHA)
        g, H = jref._pow_dual_grad_H(Z, ja)
        zt = jref._pow_grad_primal(S, ja, np.float64)
    want = jref._primal_dual_scaling_3d(H, g, zt, S, Z, np.float64)
    got = tnon._primal_dual_scaling_3d(
        t(np.asarray(H)), t(np.asarray(g)), t(np.asarray(zt)), t(S), t(Z),
        torch.float64)
    close(flat(got), want)


@pytest.mark.parametrize("kind", ["exp", "pow"])
def test_higher_correction(kind):
    S, Z = points(kind, seed=2)
    rng = np.random.default_rng(5)
    ds, v = rng.standard_normal((2, B * C, 3))
    if kind == "exp":
        _, H = jref._exp_dual_grad_H(Z)
        want = jref._exp_higher_correction(H, Z, ds, v)
        got = tnon._exp_higher_correction(t(np.asarray(H)), t(Z), t(ds),
                                          t(v))
    else:
        ja = jnp.full((B * C,), ALPHA)
        _, H = jref._pow_dual_grad_H(Z, ja)
        want = jref._pow_higher_correction(H, Z, ja, ds, v)
        got = tnon._pow_higher_correction(
            t(np.asarray(H)), t(Z), torch.full((C,), ALPHA,
                                               dtype=torch.float64),
            t(ds), t(v))
    close(flat(got), want)


def _layout_pair(kind):
    cone = {"exp": lambda m: m.ExponentialConeT(),
            "pow": lambda m: m.PowerConeT(ALPHA),
            "genpow": lambda m: m.GenPowerConeT(GP_ALPHA, GP_D2)}[kind]
    return (JLayout([ct.NonnegativeConeT(2)] + [cone(ct)] * C),
            TLayout([ctt.NonnegativeConeT(2)] + [cone(ctt)] * C))


def _lanes(kind, seed):
    """(B, m) interior z, s and directions for the layout of _layout_pair;
    the directions are long enough that the backtracking must cut them."""
    rng = np.random.default_rng(seed)
    S, Z = points(kind, seed)
    w = S.shape[1]
    nn_s, nn_z = rng.uniform(0.5, 2.0, (2, B, 2))
    s = np.concatenate([nn_s, S.reshape(B, w * C)], 1)
    z = np.concatenate([nn_z, Z.reshape(B, w * C)], 1)
    ds, dz = 3.0 * rng.standard_normal((2, B, 2 + w * C))
    return z, s, dz, ds


@pytest.mark.parametrize("kind", ["exp", "pow", "genpow"])
def test_step_length(kind):
    jl, tl = _layout_pair(kind)
    z, s, dz, ds = _lanes(kind, seed=3)
    amax = np.random.default_rng(4).uniform(0.5, 1.0, B)
    st = ct.Settings()
    want = jax.vmap(lambda *a: jops.step_length(jl, None, *a, st))(
        dz, ds, z, s, amax)
    got = tops.step_length(tl, None, *(torch.from_numpy(a) for a in
                                       (dz, ds, z, s, amax)), ctt.Settings())
    close(got, want)
    assert (np.asarray(want) < amax).any()   # the backtracking did cut


@pytest.mark.parametrize("kind", ["exp", "pow", "genpow"])
def test_compute_barrier(kind):
    jl, tl = _layout_pair(kind)
    z, s, dz, ds = _lanes(kind, seed=6)
    alpha = np.full(B, 0.01)
    want = jax.vmap(lambda *a: jops.compute_barrier(jl, None, *a))(
        z, s, dz, ds, alpha)
    got = tops.compute_barrier(tl, None, *(torch.from_numpy(a) for a in
                                           (z, s, dz, ds, alpha)))
    assert np.isfinite(np.asarray(want)).all()
    close(got, want)


def test_genpow_gradients_and_hessian_data():
    S, Z = points("genpow", seed=8)
    d1 = len(GP_ALPHA)
    a = torch.tensor(GP_ALPHA, dtype=torch.float64).expand(C, d1)
    ja = np.broadcast_to(np.asarray(GP_ALPHA), (B * C, d1))
    close(flat(tnon._genpow_grad_primal(t(S), a, d1, torch.float64)),
          jref._genpow_grad_primal(S, ja, d1, np.float64))
    got = tnon._genpow_dual_grad_H(t(Z), a, d1)
    want = jref._genpow_dual_grad_H(Z, ja, d1)
    for g, w in zip(got[:-1], want[:-1]):
        close(flat(g), w)
    assert got[-1].all() and np.asarray(want[-1]).all()
    assert tnon._genpow_is_primal_feasible(t(S), a, d1).all()
    assert tnon._genpow_is_dual_feasible(t(Z), a, d1).all()
    close(flat(tnon._genpow_barrier_dual(t(Z), a, d1)),
          jref._genpow_barrier_dual(Z, ja, d1))


def test_genpow_group_ops():
    """The genpow branches of the dispatchers: the dual scaling and its
    data, Hs and Hs^-1 (three Sherman-Morrison updates), the dense and
    diagonal Hs, the combined shift (no third-order term), the unit
    start."""
    jl, tl = _layout_pair("genpow")
    z, s, dz, ds = _lanes("genpow", seed=9)
    rng = np.random.default_rng(10)
    mu = rng.uniform(0.1, 1.0, B)
    strat = np.ones(B, np.int32)
    jst, jok = jax.jit(jax.vmap(lambda s_, z_, m_, st_: jops.update_scaling(
        jl, None, s_, z_, m_, st_)))(s, z, mu, strat)
    tt = lambda *a: [torch.from_numpy(np.asarray(x)) for x in a]
    tst, tok = tops.update_scaling(tl, None, *tt(s, z, mu, strat))
    assert np.asarray(jok).all() and tok.all()
    for gname in tst:
        for k, v in tst[gname].items():
            close(v, jst[gname][k])
    vm = lambda fn, *a: jax.jit(jax.vmap(fn))(*a)
    x = rng.standard_normal((B, tl.m))
    X = rng.standard_normal((B, tl.m, 3))
    eps = np.full(B, 1e-8)
    close(tops.mul_Hs(tl, tst, *tt(x)),
          vm(lambda st_, x_: jops.mul_Hs(jl, st_, x_), jst, x))
    close(tops.mul_Hs_inv(tl, tst, *tt(X, eps)),
          vm(lambda st_, x_, e_: jops.mul_Hs_inv(jl, st_, x_, e_),
             jst, X, eps))
    like = torch.zeros((B, 1), dtype=torch.float64)
    close(tops.hs_dense(tl, tst, like),
          vm(lambda st_: jops.hs_dense(jl, st_, jnp.float64), jst))
    close(tops.hs_diag(tl, tst, like),
          vm(lambda st_: jops.hs_diag(jl, st_, jnp.float64), jst))
    smu = rng.uniform(0.01, 1.0, B)
    close(tops.combined_ds_shift(tl, tst, *tt(dz, ds, smu, z)),
          vm(lambda st_, a, b_, c, d: jops.combined_ds_shift(
              jl, st_, a, b_, c, d), jst, dz, ds, smu, z))
    jz, js = jops.unit_initialization(jl, jnp.float64)
    tz, ts = tops.unit_initialization(tl, torch.float64, B, "cpu")
    close(tz, np.broadcast_to(jz, (B, tl.m)))
    close(ts, np.broadcast_to(js, (B, tl.m)))
