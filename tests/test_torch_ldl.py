"""The port's dense LDL against the JAX package: K2's plain version
(`clarabel_tpu_torch.linalg.batched_ldl.ldl_inverse_plain`) against the
Pallas kernel `clarabel_tpu.linalg.pallas_ldl.batched_ldl_inverse` run in
interpret mode on the CPU (and at N = 33 and 79, where that takes about
10 s, against the reference's float32 `ldl_factor` and `invert_unit_lower`,
vmapped), and the batched float64 `ldl_factor`, `invert_unit_lower`,
`ldl_solve` and `ldl_solve_via_inverse` against the reference's, vmapped.

Bars: float32 L⁻¹ and d within 1e-4 (the bar of
tests/test_pallas_kernel.py, which holds the Pallas kernel to the loop
factor); float64 within 1e-12 (two orders of summation at N = 12)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clarabel_tpu.linalg import ldl as ref_ldl
from clarabel_tpu.linalg.pallas_ldl import (batched_ldl_inverse as
                                            ref_batched_ldl_inverse,
                                            make_factor_inverse)

from clarabel_tpu_torch.linalg import batched_ldl, ldl

from test_pallas_kernel import make_kkts

F32_TOL, F64_TOL = 1e-4, 1e-12


def _port_k2(K, signs, *args):
    return batched_ldl.batched_ldl_inverse(
        torch.tensor(K, dtype=torch.float32),
        torch.tensor(signs, dtype=torch.float32), *args)


def _assert_k2_close(port, ref, tol=F32_TOL):
    Linv, d, ok = (t.numpy() for t in port)
    rLinv, rd, rok = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(ok, rok)
    np.testing.assert_allclose(Linv, rLinv, rtol=0, atol=tol)
    np.testing.assert_allclose(d, rd, rtol=0, atol=tol)


def test_plain_k2_matches_the_pallas_kernel():
    K, signs = make_kkts(256)
    ref = ref_batched_ldl_inverse(jnp.asarray(K, jnp.float32),
                                  jnp.asarray(signs, jnp.float32),
                                  interpret=True)
    port = _port_k2(K, signs)
    assert port[2].all()
    _assert_k2_close(port, ref)


def test_plain_k2_with_a_batch_that_is_not_a_multiple_of_128():
    """The reference pads to its 128-lane blocks; the port takes B as it
    is."""
    K, signs = make_kkts(100, np_=3, nm=5, seed=4)
    fi = make_factor_inverse(signs, 1e-13, 2e-7, True, interpret=True)
    ref = jax.vmap(fi)(jnp.asarray(K, jnp.float32))
    port = _port_k2(K, signs)
    assert port[0].shape == (100, 8, 8)
    _assert_k2_close(port, ref)


def test_dynamic_regularization_replaces_wrong_sign_pivots():
    """A pivot below eps, or whose sign disagrees with its static sign,
    becomes sign * delta, in both packages."""
    K, signs = make_kkts(128, np_=4, nm=4, seed=6)
    K[:, 0, 1:] = K[:, 1:, 0] = 0.0
    K[:, 0, 0] = 1e-9           # an x-block pivot below eps
    K[:, -1, -1] = 1e3          # the last z-block pivot turns positive
    eps, delta = 1e-7, 2e-5
    ref = ref_batched_ldl_inverse(jnp.asarray(K, jnp.float32),
                                  jnp.asarray(signs, jnp.float32),
                                  dyn_eps=eps, dyn_delta=delta,
                                  interpret=True)
    port = _port_k2(K, signs, eps, delta, True)
    assert port[2].all()
    _assert_k2_close(port, ref)
    d, rd = port[1].numpy(), np.asarray(ref[1])
    for j in (0, -1):
        np.testing.assert_array_equal(d[:, j],
                                      np.float32(signs[j] * np.float32(delta)))
        np.testing.assert_array_equal(rd[:, j], d[:, j])


def test_ok_is_false_on_a_singular_K():
    K, signs = make_kkts(128, np_=3, nm=3, seed=7)
    K[3] = 0.0                 # zero pivots, no regularization
    K[5, 2, 2] = np.nan        # a non-finite pivot
    ref = ref_batched_ldl_inverse(jnp.asarray(K, jnp.float32),
                                  jnp.asarray(signs, jnp.float32),
                                  dynamic_enable=False, interpret=True)
    port = _port_k2(K, signs, 1e-13, 2e-7, False)
    ok = port[2].numpy()
    assert not ok[3] and not ok[5] and ok.sum() == 126
    np.testing.assert_array_equal(ok, np.asarray(ref[2]))
    good = np.nonzero(ok)[0]
    _assert_k2_close(tuple(t[good] for t in port),
                     tuple(np.asarray(a)[good] for a in ref))


@pytest.mark.parametrize("np_,nm", [(10, 23), (26, 53)])
def test_plain_k2_matches_the_reference_at_wide_n(np_, nm):
    """N = 33 and 79, the range of the wide rows build
    (csrc/ldl_inverse_rows_wide.cu), with the dynamic regularization
    tripped on a quarter of the lanes: the plain version against the
    reference's float32 `ldl_factor` and `invert_unit_lower`, vmapped."""
    K, signs = make_kkts(128, np_=np_, nm=nm, seed=np_)
    K[0::4, 0, 1:] = K[0::4, 1:, 0] = 0.0
    K[0::4, 0, 0] = 1e-9                  # an x-block pivot below eps
    eps, delta = 1e-7, 2e-5               # Settings.throughput()'s
    sj = jnp.asarray(signs, jnp.float32)

    def factor_inverse(k):
        L, d, ok = ref_ldl.ldl_factor(k, sj, eps, delta, True)
        return ref_ldl.invert_unit_lower(L), d, ok

    ref = jax.jit(jax.vmap(factor_inverse))(jnp.asarray(K, jnp.float32))
    port = _port_k2(K, signs, eps, delta, True)
    assert port[0].shape == (128, np_ + nm, np_ + nm)
    assert port[2].all()
    _assert_k2_close(port, ref)
    d = port[1].numpy()[0::4, 0]
    np.testing.assert_array_equal(d, np.float32(delta))
    np.testing.assert_array_equal(np.asarray(ref[1])[0::4, 0], d)


def test_the_wrapper_refuses_cpu_and_mixed_devices():
    K = torch.zeros((2, 3, 3))
    signs = torch.ones(3)
    before = batched_ldl.kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        batched_ldl.kernel(K, signs, 1e-13, 2e-7, True)
    with pytest.raises(ValueError, match="mixed devices"):
        batched_ldl.batched_ldl_inverse(K, signs.to("meta"))
    assert batched_ldl.kernel.launches == before == 0


@pytest.mark.parametrize("n", [1, 5, 19, 32, 33, 80])
def test_the_wrapper_picks_its_kernel_by_n(n):
    """Every N takes the rows design, built for that N alone: N enters its
    build (-DK2_N) and its library's name; csrc/ldl_inverse_rows.cu (one
    warp an instance) up to 32, csrc/ldl_inverse_rows_wide.cu (several)
    above.  The shared-memory kernel (the variant ()) is one build for
    every N, which no path routes to."""
    kern = batched_ldl.kernel
    variant = kern.variant(n)
    path = os.path.basename(kern.lib_path(variant))
    assert variant == (n,)
    assert kern.macros == ("K2_N",)
    if n <= batched_ldl.ONE_WARP_MAX_N:
        assert os.path.basename(kern.source_for(variant)) == \
            "ldl_inverse_rows.cu"
        assert path.startswith(f"ldl_inverse_rows_n{n}_")
    else:
        assert os.path.basename(kern.source_for(variant)) == \
            "ldl_inverse_rows_wide.cu"
        assert path.startswith(f"ldl_inverse_rows_wide_n{n}_")
    shared = os.path.basename(kern.lib_path(()))
    assert os.path.basename(kern.source_for(())) == "ldl_inverse.cu"
    assert shared.startswith("ldl_inverse_") and "_n" not in shared
    others = {kern.lib_path(kern.variant(k)) for k in (5, 19, 32, 33, 80)}
    assert len(others) == 5     # one library per N


def test_the_wrapper_refuses_cpu_tensors_at_every_n():
    for n in (5, 19, 80):
        K = torch.zeros((2, n, n))
        signs = torch.ones(n)
        with pytest.raises(ValueError, match="CUDA"):
            batched_ldl.kernel(K, signs, 1e-13, 2e-7, True)
        with pytest.raises(ValueError, match="mixed devices"):
            batched_ldl.batched_ldl_inverse(K, signs.to("meta"))
    assert batched_ldl.kernel.launches == 0
    assert not batched_ldl.kernel.source_launches


def test_f64_ldl_matches_the_reference():
    K, signs = make_kkts(16, seed=2)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((16, K.shape[1], 2))
    args = (1e-13, 2e-7, True)
    rL, rd, rok = jax.vmap(lambda k: ref_ldl.ldl_factor(
        k, jnp.asarray(signs), *args))(jnp.asarray(K))
    rLinv = jax.vmap(ref_ldl.invert_unit_lower)(rL)
    rx_inv = jax.vmap(ref_ldl.ldl_solve_via_inverse)(rLinv, rd,
                                                     jnp.asarray(rhs))
    rx = jax.vmap(ref_ldl.ldl_solve)(rL, rd, jnp.asarray(rhs))

    Kt, rhs_t = torch.tensor(K), torch.tensor(rhs)
    L, d, ok = ldl.ldl_factor(Kt, torch.tensor(signs), *args)
    Linv = ldl.invert_unit_lower(L)
    assert ok.all() and bool(np.all(rok))
    for got, want in ((L, rL), (d, rd), (Linv, rLinv),
                      (ldl.ldl_solve_via_inverse(Linv, d, rhs_t), rx_inv),
                      (ldl.ldl_solve(L, d, rhs_t), rx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F64_TOL)
    # one right-hand side as a vector, too
    np.testing.assert_allclose(
        ldl.ldl_solve_via_inverse(Linv, d, rhs_t[..., 0]).numpy(),
        np.asarray(rx_inv)[..., 0], rtol=0, atol=F64_TOL)


def test_blocked_f64_ldl_matches_the_reference():
    """`ldl_factor_blocked` (the dense ldl loop's factor for N > 512)
    against the reference's, vmapped: N = 12 padded with unit pivots to
    16, as the KKT code pads it, in two blocks of 8."""
    K, signs = make_kkts(4, seed=5)
    N = K.shape[1]
    Np = -(-N // 8) * 8
    Kp = np.zeros((4, Np, Np))
    Kp[:, :N, :N] = K
    Kp[:, np.arange(N, Np), np.arange(N, Np)] = 1.0
    sp = np.concatenate([signs, np.ones(Np - N)])
    args = (1e-13, 2e-7, True)
    rL, rd, rok = jax.vmap(lambda k: ref_ldl.ldl_factor_blocked(
        k, jnp.asarray(sp), *args, block=8))(jnp.asarray(Kp))
    L, d, ok = ldl.ldl_factor_blocked(torch.tensor(Kp), torch.tensor(sp),
                                      *args, block=8)
    assert ok.all() and bool(np.all(rok))
    for got, want in ((L, rL), (d, rd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F64_TOL)
