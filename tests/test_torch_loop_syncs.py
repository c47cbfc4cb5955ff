"""The loop solver's inner loops with one host check every few trips,
against the loops that check after every trip.

The oracles below are the four loops as the port wrote them before they
went through `clarabel_tpu_torch.trips.run_trips`: each asks the host after
every trip whether a lane still runs.  Each repaired loop must give every
lane the same bits as its oracle (compared bitwise, so NaN lanes count as
equal), on seeded inputs with lanes that end at the first trip, at the cap
and never.  Then the ldl and condensed loop solve the cases of
`tests/torch_fixtures/loop_nonsym.npz` (exp, pow and the forced switch,
8 lanes) and `loop_psd_genpow.npz` (psd2, psd3, psd_zero, the bucketed PSD
layout and genpow, 16 lanes) once as they stand and once with the oracles
patched in, and every output must be bit-equal between the two runs.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import trips
from clarabel_tpu_torch.cones import nonsymmetric as ns
from clarabel_tpu_torch.interop import cone_from_tuple
from clarabel_tpu_torch.ipm import loop
from clarabel_tpu_torch.kkt import condensed, refine

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))
import make_psd_genpow_fixtures as fx  # noqa: E402
from test_megakernel_nonsym import _exp_batch, _pow_batch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the oracles: one host check per trip ----

def oracle_refine(apply_fn, kkt_mv, rhs, x, abstol, reltol, stop_ratio,
                  max_iter):
    normb = refine._inf_norm(rhs)
    e = rhs - kkt_mv(x)
    norme = refine._inf_norm(e)
    ok = torch.isfinite(norme)
    done = torch.zeros_like(ok)
    target = abstol + reltol * normb
    tiny = torch.finfo(norme.dtype).tiny
    for _ in range(max_iter):
        act = ~done & ok & (norme > target)
        if not bool(act.any()):
            break
        xnew = x + apply_fn(e)
        enew = rhs - kkt_mv(xnew)
        nn = refine._inf_norm(enew)
        okn = torch.isfinite(nn)
        ratio = norme / torch.where(nn != 0, nn, torch.full_like(nn, tiny))
        stop = ratio < stop_ratio
        accept = okn & (~stop | (ratio > 1.0)) & act
        done = torch.where(act, stop | ~okn, done)
        ok = torch.where(act, ok & okn, ok)
        x = torch.where(refine._lanes(accept, x), xnew, x)
        e = torch.where(refine._lanes(accept, e), enew, e)
        norme = torch.where(accept, nn, norme)
    return x, ok


def oracle_newton(x0, f0, f1, dtype):
    eps = float(torch.finfo(dtype).eps)
    sqrt_eps = math.sqrt(eps)
    x = x0
    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    for _ in range(100):
        if bool(done.all()):
            break
        dfdx = f1(x)
        dx = -f0(x) / torch.where(dfdx != 0, dfdx, 1.0)
        stop = ((dx < eps)
                | ((dx / torch.where(x != 0, x, 1.0)).abs() < sqrt_eps)
                | (dfdx.abs() < eps))
        x = torch.where(done | stop, x, x + dx)
        done = done | stop
    return x


def oracle_backtrack_search(Q, dQ, feas_fcn, alpha_init, alpha_min, step):
    a = alpha_init[:, None].expand(Q.shape[:2]).clone()
    done = torch.zeros(Q.shape[:2], dtype=torch.bool, device=Q.device)
    while not bool(done.all()):
        feas = feas_fcn(Q + a[..., None] * dQ)
        newdone = done | feas
        a = torch.where(newdone, a, a * step)
        killed = ~newdone & (a < alpha_min)
        a = torch.where(killed, 0.0, a)
        done = newdone | killed
    return a.amin(dim=1)


def oracle_backtrack_to_barrier(barrier, alpha_init, active, step, max_iter):
    alpha = alpha_init
    done = ~active
    for _ in range(max_iter):
        if bool(done.all()):
            break
        good = barrier(alpha) < 1.0
        alpha = torch.where(done | good, alpha, alpha * step)
        done = done | good
    return alpha


def bit_equal(a, b):
    """Same dtype, shape and bits (NaN lanes included)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = a.contiguous().view(torch.uint8), b.contiguous().view(
            torch.uint8)
    return bool(torch.equal(a, b))


# ---- each loop against its oracle ----

def _system(rng, B, N):
    """Per-lane SPD K (B, N, N), and an apply function: an exact inverse on
    the first lanes (done before the first trip), a perturbed one in the
    middle (several trips), a useless one on the last lanes (stalls at
    once, or runs to the cap)."""
    M = rng.standard_normal((B, N, N))
    K = M @ M.transpose(0, 2, 1) + N * np.eye(N)
    Kinv = np.linalg.inv(K)
    noise = rng.standard_normal((B, N, N))
    scale = np.linspace(0.0, 0.9, B)[:, None, None] / np.linalg.norm(
        Kinv, axis=(1, 2), keepdims=True) ** -1
    Ainv = Kinv + scale * noise / np.linalg.norm(noise, axis=(1, 2),
                                                  keepdims=True)
    Ainv[-2:] = -Kinv[-2:]
    Kt, At = torch.from_numpy(K), torch.from_numpy(Ainv)

    def kkt_mv(x):
        return torch.einsum("bij,bj...->bi...", Kt, x)

    def apply_fn(r):
        return torch.einsum("bij,bj...->bi...", At, r)

    return apply_fn, kkt_mv


@pytest.mark.parametrize("max_iter", [0, 1, 3, 5, 10, 40])
@pytest.mark.parametrize("cols", [None, 2])
def test_refine_matches_oracle(max_iter, cols):
    rng = np.random.default_rng(11 + max_iter)
    B, N = 24, 7
    apply_fn, kkt_mv = _system(rng, B, N)
    shape = (B, N) if cols is None else (B, N, cols)
    rhs = torch.from_numpy(rng.standard_normal(shape))
    x0 = apply_fn(rhs)
    for stop_ratio in (5.0, 1.0001):
        got = refine.refine(apply_fn, kkt_mv, rhs, x0, 1e-12, 1e-13,
                            stop_ratio, max_iter)
        want = oracle_refine(apply_fn, kkt_mv, rhs, x0, 1e-12, 1e-13,
                             stop_ratio, max_iter)
        assert bit_equal(got[0], want[0]) and bit_equal(got[1], want[1])


def test_refine_lanes_end_at_first_trip_cap_and_never():
    """The batch of the test above holds lanes that are done before the
    first trip, lanes that stop after a few, and lanes still running at a
    cap of 10 passes."""
    rng = np.random.default_rng(11)
    B, N = 24, 7
    apply_fn, kkt_mv = _system(rng, B, N)
    rhs = torch.from_numpy(rng.standard_normal((B, N)))
    xs = [oracle_refine(apply_fn, kkt_mv, rhs, apply_fn(rhs), 1e-12, 1e-13,
                        1.0001, cap)[0] for cap in range(12)]
    # lane i's passes: the first cap from which its x no longer changes
    passes = np.array([next(c for c in range(12)
                            if all(bit_equal(xs[c][i], xs[d][i])
                                   for d in range(c, 12)))
                       for i in range(B)])
    assert (passes == 0).any()
    assert ((passes > 1) & (passes < 10)).any()
    assert (passes >= 11).any()


def _newton_case(rng, B):
    """f(x) = x^3 + x - c, a start left of the root; some lanes start on
    the root (stop at the first trip), some have f' tiny and f = -1 (never
    stop: the cap)."""
    c = torch.from_numpy(rng.uniform(0.5, 50.0, (B, 3)))
    x0 = torch.from_numpy(rng.uniform(-2.0, 0.0, (B, 3)))
    root = oracle_newton(x0, lambda x: x ** 3 + x - c,
                         lambda x: 3 * x ** 2 + 1, torch.float64)
    x0[:2] = root[:2]
    slow = torch.zeros((B, 3), dtype=torch.bool)
    slow[-3:] = True

    def f0(x):
        return torch.where(slow, -torch.ones_like(x), x ** 3 + x - c)

    def f1(x):
        return torch.where(slow, torch.full_like(x, 1e-3), 3 * x ** 2 + 1)

    return x0, f0, f1


def test_newton_matches_oracle():
    rng = np.random.default_rng(5)
    x0, f0, f1 = _newton_case(rng, 32)
    got = ns._newton_raphson_onesided(x0, f0, f1, torch.float64)
    want = oracle_newton(x0, f0, f1, torch.float64)
    assert bit_equal(got, want)
    # the slow lanes ran to the cap: x0 + 100 steps of 1000
    assert torch.allclose(want[-3:], x0[-3:] + 1e5)


@pytest.mark.parametrize("alpha_min,step", [(1e-4, 0.8), (1e-3, 0.5),
                                            (1e-8, 0.9), (0.3, 0.8)])
def test_backtrack_search_matches_oracle(alpha_min, step):
    rng = np.random.default_rng(3)
    B, c = 40, 3
    Q = torch.from_numpy(rng.uniform(0.1, 1.0, (B, c, 3)))
    dQ = torch.from_numpy(rng.standard_normal((B, c, 3)) * np.logspace(
        -2, 5, B)[:, None, None])
    dQ[-4:] = -1e300     # never feasible: killed below alpha_min
    alpha_init = torch.from_numpy(rng.uniform(0.2, 1.0, B))
    alpha_init[:3] = 1.0

    def feas(W):
        return (W > 0).all(dim=-1)

    got = ns._backtrack_search(Q, dQ, feas, alpha_init, alpha_min, step)
    want = oracle_backtrack_search(Q, dQ, feas, alpha_init, alpha_min, step)
    assert bit_equal(got, want)
    assert (want[-4:] == 0).all() and (want[:3] > 0).any()
    # every lane ended within the cap the code derives
    cap = ns._backtrack_trips(alpha_min, step)
    a = alpha_init.clone()
    for _ in range(cap):
        a = a * step
    assert (a < alpha_min).all()


@pytest.mark.parametrize("max_iter", [0, 2, 4, 7, 50])
def test_backtrack_to_barrier_matches_oracle(max_iter):
    rng = np.random.default_rng(9)
    B = 48
    target = torch.from_numpy(rng.uniform(0.0, 1.2, B))
    target[-3:] = -1.0          # no step passes: the cap
    alpha_init = torch.from_numpy(rng.uniform(0.5, 1.0, B))
    active = torch.from_numpy(rng.uniform(size=B) < 0.7)

    def barrier(alpha):
        return alpha - target + 0.5

    got = loop.backtrack_to_barrier(barrier, alpha_init, active, 0.8,
                                    max_iter)
    want = oracle_backtrack_to_barrier(barrier, alpha_init, active, 0.8,
                                       max_iter)
    assert bit_equal(got, want)


def test_run_trips_checks_once_per_chunk():
    """The host reads `finished` before the first trip and after each
    TRIPS_PER_CHECK trips, and never runs past the cap."""
    reads, ran = [], []

    def finished(c):
        reads.append(c)
        return torch.tensor(c >= 9)

    def trip(c):
        ran.append(c)
        return c + 1

    assert trips.run_trips(trip, 0, finished, 100) == \
        -(-9 // trips.TRIPS_PER_CHECK) * trips.TRIPS_PER_CHECK
    assert len(reads) == 1 + -(-9 // trips.TRIPS_PER_CHECK)
    reads.clear()
    assert trips.run_trips(trip, 0, finished, 6) == 6
    assert trips.run_trips(trip, 0, finished, 0) == 0
    assert trips.run_trips(trip, 20, finished, None) == 20


# ---- the loop solver with the repaired loops against the oracles ----

NONSYM = ("exp", "pow", "switch")
PSD_GENPOW = ("psd2", "psd3", "psd_zero", "bucketed", "genpow")


def _inputs(name):
    if name in NONSYM:
        if name == "pow":
            P, q, A, b, _, n = _pow_batch(8)
            cones = [ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)]
        else:
            P, q, A, b, _, n = _exp_batch(8)
            cones = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
        over = {"min_switch_step_length": 0.9} if name == "switch" else {}
        return cones, n, over, (P, q, A, b)
    cones, n, P, q, A, b = fx.case_inputs(name, fx.LOOP_B)
    return ([cone_from_tuple(tuple(c)) for c in cones], n, {},
            (P, q, A, b))


def _solve(name, backend):
    cones, n, over, data = _inputs(name)
    bs = ctt.BatchSolver(cones, n, ctt.Settings(kkt_backend=backend, **over),
                         device="cpu")
    return bs.solve(*data)._out


@pytest.mark.parametrize("backend", ["ldl", "condensed"])
@pytest.mark.parametrize("name", NONSYM + PSD_GENPOW)
def test_loop_bit_equal_to_per_trip_loops(name, backend, monkeypatch):
    got = _solve(name, backend)
    monkeypatch.setattr(refine, "refine", oracle_refine)
    monkeypatch.setattr(condensed, "refine", oracle_refine)
    monkeypatch.setattr(ns, "_newton_raphson_onesided", oracle_newton)
    monkeypatch.setattr(ns, "_backtrack_search", oracle_backtrack_search)
    monkeypatch.setattr(loop, "backtrack_to_barrier",
                        oracle_backtrack_to_barrier)
    want = _solve(name, backend)
    assert set(got) == set(want)
    for key in want:
        assert bit_equal(got[key], want[key]), key
