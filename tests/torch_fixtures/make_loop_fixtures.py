"""Make the committed `.npz` fixtures of the JAX loop solver's inputs and
outputs that `tests/test_torch_loop.py` holds the port against.

The reference is `jax.vmap(clarabel_tpu.ipm.loop.build_solve(...))` on the
CPU, whose compile costs tens of seconds per setting at the bench shape.
So the CPU tests compare live only at n=2, and two larger batches are
solved once here and committed:

* `bench`: the bench shape (n=6, [NN(6), SOC(7)], B=64), under the four
  settings of `SETTINGS`;
* `socs`: n=4 with a zero cone, four SOCs of three sizes and a nonnegative
  cone (B=32).  Three distinct SOC sizes make the layout bucket them, so
  one SOC group holds three cones padded with the sentinel index m;
* `wide`: the bench family at n=26 ([NN(26), SOC(27)], m=53, so the KKT
  has N = 79, the widest the K2 route takes on it; B=16), under
  `Settings.throughput()` through the JAX package's `BatchSolver`.

Run from the repository root (all cases, or the ones named):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_loop_fixtures.py [bench] [socs] [wide]

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# name -> (preset, keyword arguments) of the reference's Settings.  The
# port runs the float32 ones with use_pallas=True, so that on the CPU they
# take the K2 route (its plain version); the kernel route needs the
# natural elimination order, hence dense_ldl_diag_order=False on both.
SETTINGS = {
    "ldl": (None, {"kkt_backend": "ldl"}),
    "condensed": (None, {"kkt_backend": "condensed"}),
    "throughput": ("throughput", {"dense_ldl_diag_order": False}),
    "mixed": (None, {"kkt_backend": "ldl", "mixed_precision": True,
                     "dense_ldl_diag_order": False}),
}
CASE_SETTINGS = {
    "bench": ("ldl", "condensed", "throughput", "mixed"),
    "socs": ("ldl", "condensed"),
    "wide": ("throughput",),
}
# cases the reference solves through its BatchSolver (the others through
# its vmapped build_solve, which that runs under kkt_backend="ldl")
BATCH_SOLVER_CASES = ("wide",)
OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual", "r_prim", "r_dual")


def make_settings(pkg, name, **extra):
    """`pkg.Settings` (either package's) for SETTINGS[name]."""
    preset, kw = SETTINGS[name]
    kw = dict(kw, **extra)
    if preset == "throughput":
        return pkg.Settings.throughput(**kw)
    return pkg.Settings(**kw)


def case_inputs(name):
    """(cones as (class name, dim) tuples, n, P, q, A, b)."""
    import numpy as np

    sys.path.insert(0, ROOT)
    if name in ("bench", "wide"):
        from clarabel_tpu_torch.bench_data import make_batch

        n, B = (6, 64) if name == "bench" else (26, 16)
        P, q, A, b = make_batch(B, n, seed=0)
        cones = [("NonnegativeConeT", n), ("SecondOrderConeT", n + 1)]
        return cones, n, P, q, A, b
    if name == "socs":
        B, n = 32, 4
        cones = [("ZeroConeT", 1), ("SecondOrderConeT", 3),
                 ("SecondOrderConeT", 3), ("SecondOrderConeT", 4),
                 ("SecondOrderConeT", 5), ("NonnegativeConeT", 2)]
        m = sum(d for _, d in cones)
        rng = np.random.default_rng(5)
        F = rng.standard_normal((B, n, n)) / np.sqrt(n)
        P = np.einsum("bij,bkj->bik", F, F) + 0.5 * np.eye(n)
        q = rng.standard_normal((B, n))
        A = rng.standard_normal((B, m, n))
        # b = A x0 + s0 with s0 interior (0 on the zero cone): feasible
        x0 = 0.3 * rng.standard_normal((B, n))
        s0 = np.zeros((B, m))
        lo = 1
        for _, d in cones[1:5]:
            s0[:, lo] = 1.0 + rng.uniform(0.0, 1.0, B)
            s0[:, lo + 1:lo + d] = rng.uniform(-0.3, 0.3, (B, d - 1))
            lo += d
        s0[:, lo:] = rng.uniform(0.5, 1.5, (B, 2))
        b = np.einsum("bij,bj->bi", A, x0) + s0
        return cones, n, P, q, A, b
    raise ValueError(f"unknown case {name!r}")


def run_reference(name):
    """Solve one case with the vmapped JAX loop solver on the CPU under
    each of its settings; returns the dict saved as `loop_<name>.npz`."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct
    from clarabel_tpu.cones.api import cones_collapse
    from clarabel_tpu.cones.layout import ConeLayout
    from clarabel_tpu.ipm.loop import build_solve

    cones, n, P, q, A, b = case_inputs(name)
    layout = ConeLayout(cones_collapse(
        [getattr(ct, cls)(dim) for cls, dim in cones]))
    res = {"cones": np.array(json.dumps(cones)), "n": np.array(n),
           "P": P, "q": q, "A": A, "b": b}
    for st_name in CASE_SETTINGS[name]:
        st = make_settings(ct, st_name)
        if name in BATCH_SOLVER_CASES:
            solver = ct.BatchSolver([getattr(ct, cls)(dim)
                                     for cls, dim in cones], n, st)
            out = solver.solve(P, q, A, b)._out
        else:
            fn = jax.jit(jax.vmap(build_solve(layout, st, n,
                                              p_nonzero=True)))
            out = jax.device_get(fn(P, q, A, b))
        for k in OUT_KEYS:
            res[f"ref_{st_name}_{k}"] = np.asarray(out[k])
        print(f"{name}/{st_name}: statuses "
              f"{np.bincount(out['status'], minlength=11).tolist()}",
              flush=True)
    return res


def fixture_path(name):
    return os.path.join(HERE, f"loop_{name}.npz")


def main(argv):
    import numpy as np

    for name in argv or list(CASE_SETTINGS):
        np.savez_compressed(fixture_path(name), **run_reference(name))
        print("wrote", fixture_path(name), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
