"""Make the committed `.npz` fixtures of the JAX package's PSD-triangle and
generalized-power-cone solves that the port's tests hold it against.

* `megakernel_psd2.npz`, `megakernel_psd_zero.npz`, `megakernel_genpow.npz`:
  the JAX megakernel (`clarabel_tpu/ipm/megakernel.py`) on 64 lanes of the
  side-2 SDP batch of `tests/test_megakernel_psd.py` (seed 12), of its
  equality-constrained variant (seed 77), and of the genpow batch of
  `tests/test_megakernel_nonsym.py`.  These bodies compile for minutes on
  the CPU, so the port's tests never run them live.  Beside it each file
  holds the JAX loop's solve of the same batch (`loop_*`).  The side-3
  megakernel compiles for more than 25 minutes on XLA:CPU, so side 3 is
  held against the loop only.
* `loop_psd_genpow.npz`: the JAX loop solver (`jax.vmap` of
  `clarabel_tpu/ipm/loop.py` `build_solve`, through `BatchSolver`) with the
  `ldl` and `condensed` backends on 16 lanes of the side-2 and side-3 SDP
  batches, of the zero-cone mix, of a layout with five PSD sides (which
  the layout buckets), and of the genpow batch.

Run from the repository root (all cases, or the ones named):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_psd_genpow_fixtures.py [psd2] [psd_zero] [genpow] [loop]

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual", "r_prim", "r_dual", "tau", "kappa")
MEGA_B = 64
LOOP_B = 16
LOOP_CASES = ("psd2", "psd3", "psd_zero", "bucketed", "genpow")
BACKENDS = ("ldl", "condensed")
GENPOW = ("GenPowerConeT", (0.3, 0.7), 2)


def _paths():
    for p in (ROOT, os.path.join(ROOT, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def hetero_batch(B, seed=0, sides=(2, 3, 4, 5, 6)):
    """B lanes of `tests/test_psd_bucketing.py` `hetero_sdp` (five PSD
    sides, so the layout buckets them), drawn one lane after another from
    one generator.  n=6, m=55."""
    import numpy as np
    import test_psd_bucketing as t

    rng = np.random.default_rng(seed)
    lanes = [t.hetero_sdp(rng, sides) for _ in range(B)]
    P, q, A, b = (np.stack([lane[i] for lane in lanes]) for i in range(4))
    cones = [("PSDTriangleConeT", k) for k in sides]
    return cones, 6, P, q, A, b


def case_inputs(name, B):
    """(cones as tuples, n, P, q, A, b) of a named batch."""
    _paths()
    from clarabel_tpu_torch import bench_data

    if name == "psd2":
        P, q, A, b = bench_data.make_sdp_batch(B, 2, seed=12)
        return [("NonnegativeConeT", 6), ("PSDTriangleConeT", 2)], 3, \
            P, q, A, b
    if name == "psd3":
        P, q, A, b = bench_data.make_sdp_batch(B, 3, seed=13)
        return [("NonnegativeConeT", 6), ("PSDTriangleConeT", 3)], 3, \
            P, q, A, b
    if name == "psd_zero":
        P, q, A, b = bench_data.make_sdp_zero_batch(B)
        return [("ZeroConeT", 1), ("NonnegativeConeT", 5),
                ("PSDTriangleConeT", 2)], 3, P, q, A, b
    if name == "bucketed":
        return hetero_batch(B)
    if name == "genpow":
        P, q, A, b = bench_data.make_genpow_batch(B)
        return [("NonnegativeConeT", 2), GENPOW], 4, P, q, A, b
    raise ValueError(name)


def _solve(cones, n, settings, P, q, A, b):
    import numpy as np
    import clarabel_tpu as ct

    spec = [getattr(ct, c)(*args) for c, *args in cones]
    out = ct.BatchSolver(spec, n, ct.Settings(**settings)).solve(P, q, A, b)
    return {k: np.asarray(out._out[k]) for k in OUT_KEYS}


def run_reference(name):
    """One fixture file's contents: a megakernel case or all loop cases."""
    import numpy as np

    _paths()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if name == "loop":
        res = {}
        for case in LOOP_CASES:
            cones, n, P, q, A, b = case_inputs(case, LOOP_B)
            for backend in BACKENDS:
                out = _solve(cones, n, {"kkt_backend": backend},
                             P, q, A, b)
                for k, v in out.items():
                    res[f"{case}_{backend}_{k}"] = v
                print(case, backend, "done", flush=True)
        return res
    cones, n, P, q, A, b = case_inputs(name, MEGA_B)
    out = _solve(cones, n, {"kkt_backend": "megakernel"}, P, q, A, b)
    res = {"cones": np.array(json.dumps(cones)), "n": np.array(n),
           "settings": np.array(json.dumps({})),
           "P": P, "q": q, "A": A, "b": b}
    res.update({"ref_" + k: v for k, v in out.items()})
    loop = _solve(cones, n, {"kkt_backend": "condensed"}, P, q, A, b)
    res.update({"loop_" + k: loop[k]
                for k in ("x", "status", "iterations", "obj_val")})
    return res


def fixture_path(name):
    return os.path.join(HERE, ("loop_psd_genpow.npz" if name == "loop"
                               else f"megakernel_{name}.npz"))


def main(argv):
    import numpy as np

    for name in argv or ["loop", "psd2", "psd_zero", "genpow"]:
        np.savez_compressed(fixture_path(name), **run_reference(name))
        print("wrote", fixture_path(name), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
