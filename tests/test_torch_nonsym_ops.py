"""The port's exponential and power cone operations against the JAX package.

Each ported function of `clarabel_tpu_torch/cones/nonsymmetric.py` (and
the barrier of `cones/ops.py`) runs on seeded interior points, drawn with
numpy, beside its counterpart in `clarabel_tpu/cones/nonsymmetric.py`.
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


def points(kind, seed=0):
    rng = np.random.default_rng(seed)
    return (exp_points if kind == "exp" else pow_points)(rng, B * C)


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
    cone = (lambda m: m.ExponentialConeT()) if kind == "exp" else \
        (lambda m: m.PowerConeT(ALPHA))
    return (JLayout([ct.NonnegativeConeT(2)] + [cone(ct)] * C),
            TLayout([ctt.NonnegativeConeT(2)] + [cone(ctt)] * C))


def _lanes(kind, seed):
    """(B, m) interior z, s and directions for the layout of _layout_pair;
    the directions are long enough that the backtracking must cut them."""
    rng = np.random.default_rng(seed)
    S, Z = points(kind, seed)
    nn_s, nn_z = rng.uniform(0.5, 2.0, (2, B, 2))
    s = np.concatenate([nn_s, S.reshape(B, 3 * C)], 1)
    z = np.concatenate([nn_z, Z.reshape(B, 3 * C)], 1)
    ds, dz = 3.0 * rng.standard_normal((2, B, 2 + 3 * C))
    return z, s, dz, ds


@pytest.mark.parametrize("kind", ["exp", "pow"])
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


@pytest.mark.parametrize("kind", ["exp", "pow"])
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
