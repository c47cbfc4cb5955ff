"""How far x is pinned at the bench shape: the JAX package's own condensed
loop against its megakernel, and the port against the megakernel, on the
committed 64-lane bench fixture (`megakernel_bench.npz`).

Prints the largest |dx| of each pair over the lanes both solve, and each
pair's largest ratio of |dx| to the sum of the two solutions' certificate
radii sqrt(2 gap / lambda_min(P)) (the distance a point with duality gap
`gap` can lie from the optimum of a QP with that P).  The JAX condensed
loop compiles in about half a minute on the CPU.  Run from the repository
root:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/reference_spread.py
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def radius(P, gap):
    import numpy as np

    return np.sqrt(2.0 * np.abs(gap) / np.linalg.eigvalsh(P)[:, 0])


def main():
    import numpy as np

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct
    import clarabel_tpu_torch as ctt

    f = np.load(os.path.join(HERE, "megakernel_bench.npz"))
    P, q, A, b = f["P"], f["q"], f["A"], f["b"]
    n = int(f["n"])
    mega = {"x": f["ref_x"], "status": f["ref_status"],
            "gap": f["ref_obj_val"] - f["ref_obj_val_dual"]}
    cond = ct.BatchSolver([ct.NonnegativeConeT(n), ct.SecondOrderConeT(n + 1)],
                          n, ct.Settings(kkt_backend="condensed")).solve(
                              P, q, A, b)
    port = ctt.BatchSolver(
        [ctt.NonnegativeConeT(n), ctt.SecondOrderConeT(n + 1)], n,
        device="cpu").solve(P, q, A, b)
    for name, sol in (("jax condensed loop", cond), ("port", port)):
        other = {"x": sol.x, "status": sol.status,
                 "gap": sol.obj_val - np.asarray(sol._out["obj_val_dual"])}
        both = (other["status"] == 1) & (mega["status"] == 1)
        dx = np.abs(other["x"] - mega["x"]).max(axis=1)[both]
        rad = (radius(P, other["gap"]) + radius(P, mega["gap"]))[both]
        print(f"{name} vs jax megakernel on {both.sum()} lanes: max|dx| "
              f"{dx.max():.3e} (lane {np.nonzero(both)[0][dx.argmax()]}), "
              f"max |dx|/radius {(dx / rad).max():.3f}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
