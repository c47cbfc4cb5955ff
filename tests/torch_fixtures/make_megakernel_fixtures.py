"""Make the committed `.npz` fixtures of the JAX megakernel's inputs and
outputs that `tests/test_torch_megakernel.py` holds the port against.

The JAX megakernel (`clarabel_tpu/ipm/megakernel.py`) runs on the CPU
through an ahead-of-time compile with fusion disabled, which costs about a
minute at n=2 and about seven minutes at the bench shape (n=6, m=13).  So
the CPU tests compare live only at n=2; the LP batch, the zero-cone batch
and the bench shape are solved once here and committed.

Run from the repository root (all cases, or the ones named):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_megakernel_fixtures.py [lp] [zero] [bench]

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# solver outputs stored per case (BatchSolution fields + diagnostics)
OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual", "r_prim", "r_dual", "tau", "kappa")


def case_inputs(name):
    """(cones as (class name, dim) tuples, n, p_nonzero, P, q, A, b)."""
    import numpy as np

    if name == "lp":
        # tests/test_megakernel.py test_lp_batch
        B, n = 8, 2
        rng = np.random.default_rng(3)
        q = np.abs(rng.standard_normal((B, n))) + 0.2
        A = np.tile(np.vstack([-np.eye(n), [[1.0, 0.3], [0.2, 1.0]]]),
                    (B, 1, 1))
        b = np.concatenate([np.zeros((B, n)),
                            np.abs(rng.standard_normal((B, 2))) + 1.0],
                           axis=1)
        P = np.zeros((B, n, n))
        cones = [("NonnegativeConeT", 2), ("SecondOrderConeT", 2)]
        return cones, n, False, P, q, A, b
    if name == "zero":
        # tests/test_megakernel.py test_zero_cone_batch_matches_loop
        B, n = 8, 3
        rng = np.random.default_rng(11)
        F = rng.standard_normal((B, n, n))
        P = np.einsum("bij,bkj->bik", F, F) + np.eye(n)
        q = rng.standard_normal((B, n))
        A = np.zeros((B, 6, n))
        b = np.zeros((B, 6))
        A[:, 0, :] = 1.0
        b[:, 0] = 1.0
        A[:, 1:3, :2] = np.eye(2)
        b[:, 1:3] = rng.uniform(0.5, 1.5, (B, 2))
        A[:, 4:6, 1:3] = -np.eye(2)
        b[:, 3] = rng.uniform(1.0, 2.0, B)
        b[:, 4:6] = -rng.standard_normal((B, 2)) * 0.2
        cones = [("ZeroConeT", 1), ("NonnegativeConeT", 2),
                 ("SecondOrderConeT", 3)]
        return cones, n, True, P, q, A, b
    if name == "bench":
        # the bench shape: n=6, [NN(6), SOC(7)], B=64
        sys.path.insert(0, ROOT)
        from clarabel_tpu_torch.bench_data import make_batch

        n = 6
        P, q, A, b = make_batch(64, n, seed=0)
        cones = [("NonnegativeConeT", n), ("SecondOrderConeT", n + 1)]
        return cones, n, True, P, q, A, b
    raise ValueError(f"unknown case {name!r}")


def run_reference(name):
    """Solve one case with the JAX megakernel on the CPU; returns the
    dict that is saved as `megakernel_<name>.npz`."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct

    cones, n, p_nonzero, P, q, A, b = case_inputs(name)
    spec = [getattr(ct, cls)(dim) for cls, dim in cones]
    bs = ct.BatchSolver(spec, n, ct.Settings(kkt_backend="megakernel"),
                        p_nonzero=p_nonzero)
    out = bs.solve(P if p_nonzero else None, q, A, b)
    res = {"cones": np.array(json.dumps(cones)), "n": np.array(n),
           "p_nonzero": np.array(p_nonzero), "P": P, "q": q, "A": A,
           "b": b}
    for k in OUT_KEYS:
        res["ref_" + k] = np.asarray(out._out[k])
    return res


def fixture_path(name):
    return os.path.join(HERE, f"megakernel_{name}.npz")


def main(argv):
    import numpy as np

    for name in argv or ["lp", "zero", "bench"]:
        np.savez_compressed(fixture_path(name), **run_reference(name))
        print("wrote", fixture_path(name), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
