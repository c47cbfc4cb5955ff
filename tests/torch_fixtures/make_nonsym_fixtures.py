"""Make the committed `.npz` fixtures of the JAX package's exponential- and
power-cone solves that the port's nonsymmetric tests hold it against.

* `megakernel_exp.npz`, `megakernel_pow.npz`, `megakernel_switch.npz`: the
  JAX megakernel (`clarabel_tpu/ipm/megakernel.py`) on 64 lanes of the
  exponential-cone batch of `bench.py`, of the power-cone batch of
  `tests/test_megakernel_nonsym.py`, and of the exponential batch again
  with `min_switch_step_length` raised to 0.9, where lanes take the
  PrimalDual->Dual switch.  Its nonsymmetric body compiles for minutes on
  the CPU, so `tests/test_torch_megakernel_nonsym.py` never runs it live.
  Beside it each file holds the JAX loop's solve of the same batch
  (`loop_*`): the f32-pair megakernel ends some lanes tens of iterations
  after the float64 loop does.
* `loop_nonsym.npz`: the JAX loop solver (`jax.vmap` of
  `clarabel_tpu/ipm/loop.py` `build_solve`, through `BatchSolver`) on the
  8-lane batches of `tests/test_megakernel_nonsym.py`, with the `ldl` and
  `condensed` backends, and on the exponential batch with the switch
  setting.  `tests/test_torch_loop_nonsym.py` compares one of them live.

Run from the repository root (all cases, or the ones named):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_nonsym_fixtures.py [exp] [pow] [switch] [loop]

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual", "r_prim", "r_dual", "tau", "kappa")
SWITCH = 0.9          # min_switch_step_length of the switch cases
LOOP_CASES = (("exp", "condensed"), ("exp", "ldl"), ("pow", "ldl"),
              ("pow", "condensed"), ("switch", "ldl"),
              ("switch", "condensed"))


def _paths():
    for p in (ROOT, os.path.join(ROOT, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def megakernel_inputs(name):
    """(cones as tuples, n, settings overrides, P, q, A, b), 64 lanes."""
    _paths()
    from clarabel_tpu_torch import bench_data

    if name == "pow":
        data = bench_data.make_pow_batch(64)
        cones = [("NonnegativeConeT", 2), ("PowerConeT", 0.6)]
    else:
        data = bench_data.make_exp_batch(64)
        cones = [("NonnegativeConeT", 2), ("ExponentialConeT",)]
    over = {"min_switch_step_length": SWITCH} if name == "switch" else {}
    return (cones, 3, over) + tuple(data)


def loop_inputs(name):
    """The 8-lane batch of tests/test_megakernel_nonsym.py for a loop case:
    (cones as tuples, n, settings overrides, P, q, A, b)."""
    _paths()
    import test_megakernel_nonsym as t

    if name == "pow":
        P, q, A, b, _, n = t._pow_batch(8)
        cones = [("NonnegativeConeT", 2), ("PowerConeT", 0.6)]
    else:
        P, q, A, b, _, n = t._exp_batch(8)
        cones = [("NonnegativeConeT", 2), ("ExponentialConeT",)]
    over = {"min_switch_step_length": SWITCH} if name == "switch" else {}
    return cones, n, over, P, q, A, b


def _solve(cones, n, settings, P, q, A, b):
    import numpy as np
    import clarabel_tpu as ct

    spec = [getattr(ct, c)(*args) for c, *args in cones]
    out = ct.BatchSolver(spec, n, ct.Settings(**settings)).solve(P, q, A, b)
    return {k: np.asarray(out._out[k]) for k in OUT_KEYS}


def loop_of_megakernel_case(name):
    """The JAX loop (condensed) on a megakernel case's batch, as the
    `loop_*` entries of its file."""
    cones, n, over, P, q, A, b = megakernel_inputs(name)
    out = _solve(cones, n, dict(over, kkt_backend="condensed"), P, q, A, b)
    return {"loop_" + k: out[k]
            for k in ("x", "status", "iterations", "obj_val")}


def run_reference(name):
    """One fixture file's contents: a megakernel case ("exp", "pow",
    "switch") or all loop cases ("loop")."""
    import numpy as np

    _paths()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if name == "loop":
        res = {}
        for case, backend in LOOP_CASES:
            cones, n, over, P, q, A, b = loop_inputs(case)
            out = _solve(cones, n, dict(over, kkt_backend=backend),
                         P, q, A, b)
            for k, v in out.items():
                res[f"{case}_{backend}_{k}"] = v
        return res
    cones, n, over, P, q, A, b = megakernel_inputs(name)
    out = _solve(cones, n, dict(over, kkt_backend="megakernel"), P, q, A, b)
    res = {"cones": np.array(json.dumps(cones)), "n": np.array(n),
           "settings": np.array(json.dumps(over)),
           "P": P, "q": q, "A": A, "b": b}
    res.update({"ref_" + k: v for k, v in out.items()})
    res.update(loop_of_megakernel_case(name))
    return res


def fixture_path(name):
    return os.path.join(HERE, ("loop_nonsym.npz" if name == "loop"
                               else f"megakernel_{name}.npz"))


def main(argv):
    import numpy as np

    for name in argv or ["loop", "exp", "pow", "switch"]:
        np.savez_compressed(fixture_path(name), **run_reference(name))
        print("wrote", fixture_path(name), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
