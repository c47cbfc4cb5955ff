"""Make the committed `.npz` fixtures of the JAX megakernel's two-phase
solve (`Settings(megakernel_two_phase=True)`: float32 iterations while mu
is above `megakernel_switch_mu`, then the double-float loop) that
`tests/test_torch_megakernel_two_phase.py` holds the port's K1e against.

Three batches of 64 lanes, each solved by the JAX megakernel with the
two-phase schedule (`ref_*`) and with the single phase (`single_*`):

* `tiny`: the n=2 layout of `tests/test_megakernel.py` ([NN(2), SOC(2)]),
  `_batch(64, seed=3)` with every 8th lane primal infeasible;
* `bench`: the bench shape (n=6, [NN(6), SOC(7)], `make_batch` seed 0);
* `psd2`: the side-2 SDP batch of `tests/test_megakernel_psd.py`
  (n=3, [NN(6), PSD(2)], `make_sdp_batch` seed 12).

The JAX megakernel compiles on the CPU for minutes per program (about one
at n=2, more at the bench shape and at psd2), so the port's tests never
run it live.  Side 3 does not compile on XLA:CPU in reasonable time
(`make_psd_genpow_fixtures.py`), so psd3 is held on the card only.

Run from the repository root (all cases, or the ones named; run cases as
separate processes to compile them side by side):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_two_phase_fixtures.py [tiny] [bench] [psd2]

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual", "r_prim", "r_dual", "tau", "kappa")
B = 64
CASES = ("tiny", "bench", "psd2")
INFEASIBLE_EVERY = 8


def tiny_batch(B, seed=3, infeasible_every=INFEASIBLE_EVERY):
    """`tests/test_megakernel.py` `_batch(B, seed, infeasible_lanes)` with
    every `infeasible_every`-th lane infeasible (x0 <= -1 and x0 >= 1;
    none for None)."""
    import numpy as np

    n, m = 2, 4
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", F, F) + np.eye(n)
    q = rng.standard_normal((B, n))
    A = np.tile(np.vstack([np.eye(n), [[1.0, 0.3], [0.2, 1.0]]]),
                (B, 1, 1))
    b = np.abs(rng.standard_normal((B, m))) + 1.0
    for i in range(0, B, infeasible_every) if infeasible_every else ():
        A[i, 0] = [1.0, 0.0]
        A[i, 1] = [-1.0, 0.0]
        b[i, 0] = -1.0
        b[i, 1] = -1.0
    return P, q, A, b


def case_inputs(name):
    """(cones as (class name, dim) tuples, n, P, q, A, b) of a case."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from clarabel_tpu_torch import bench_data

    if name == "tiny":
        return ([("NonnegativeConeT", 2), ("SecondOrderConeT", 2)], 2,
                *tiny_batch(B))
    if name == "bench":
        return ([("NonnegativeConeT", 6), ("SecondOrderConeT", 7)], 6,
                *bench_data.make_batch(B, 6, seed=0))
    if name == "psd2":
        return ([("NonnegativeConeT", 6), ("PSDTriangleConeT", 2)], 3,
                *bench_data.make_sdp_batch(B, 2, seed=12))
    raise ValueError(f"unknown case {name!r}")


def run_reference(name):
    """Solve one case with the JAX megakernel on the CPU, two-phase and
    single-phase; returns the dict saved as `two_phase_<name>.npz`."""
    import numpy as np

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct

    cones, n, P, q, A, b = case_inputs(name)
    spec = [getattr(ct, cls)(dim) for cls, dim in cones]
    res = {"cones": np.array(json.dumps(cones)), "n": np.array(n),
           "P": P, "q": q, "A": A, "b": b}
    for tag, two_phase in (("ref_", True), ("single_", False)):
        st = ct.Settings(kkt_backend="megakernel",
                         megakernel_two_phase=two_phase)
        out = ct.BatchSolver(spec, n, st).solve(P, q, A, b)
        for k in OUT_KEYS:
            res[tag + k] = np.asarray(out._out[k])
        print(name, tag, "done", flush=True)
    return res


def fixture_path(name):
    return os.path.join(HERE, f"two_phase_{name}.npz")


def main(argv):
    import numpy as np

    for name in argv or CASES:
        np.savez_compressed(fixture_path(name), **run_reference(name))
        print("wrote", fixture_path(name), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
