"""What rounding alone moves in the JAX package, at the sizes the port's
fixtures hold it to.

`x`: how far x is pinned at the bench shape: the JAX package's own
condensed loop against its megakernel, and the port's megakernel (plain
version) against the JAX megakernel, on the committed 64-lane bench fixture
(`megakernel_bench.npz`).  Prints the largest |dx| of each pair over the
lanes both solve, and each pair's largest ratio of |dx| to the sum of the
two solutions' certificate radii sqrt(2 gap / lambda_min(P)) (the distance
a point with duality gap `gap` can lie from the optimum of a QP with that
P).

`floor`: the statuses of the JAX dense ldl loop at its accuracy floor: on
the committed loop fixtures (`loop_bench.npz`, `loop_socs.npz`), the lanes
whose status moves when q moves by 1e-15 (relative), for three draws.

`wide`: the same for the JAX package's BatchSolver under
`Settings.throughput()` (float32) on the committed n = 26 fixture
(`loop_wide.npz`), q moved by 1e-15 and by 1e-7 (relative, float32's
rounding), for three draws.

Each JAX solver compiles for half a minute or so on the CPU.  Run from the
repository root (all parts, or the ones named):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/reference_spread.py [x] [floor] [wide]
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def radius(P, gap):
    import numpy as np

    return np.sqrt(2.0 * np.abs(gap) / np.linalg.eigvalsh(P)[:, 0])


def x_spread():
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
        ctt.Settings(kkt_backend="megakernel"), device="cpu").solve(
            P, q, A, b)
    for name, sol in (("jax condensed loop", cond), ("port", port)):
        other = {"x": sol.x, "status": sol.status,
                 "gap": sol.obj_val - np.asarray(sol._out["obj_val_dual"])}
        both = (other["status"] == 1) & (mega["status"] == 1)
        dx = np.abs(other["x"] - mega["x"]).max(axis=1)[both]
        rad = (radius(P, other["gap"]) + radius(P, mega["gap"]))[both]
        print(f"{name} vs jax megakernel on {both.sum()} lanes: max|dx| "
              f"{dx.max():.3e} (lane {np.nonzero(both)[0][dx.argmax()]}), "
              f"max |dx|/radius {(dx / rad).max():.3f}")



def status_floor():
    import json

    import numpy as np

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct
    from clarabel_tpu.cones.api import cones_collapse
    from clarabel_tpu.cones.layout import ConeLayout
    from clarabel_tpu.ipm.loop import build_solve

    for case in ("bench", "socs"):
        f = np.load(os.path.join(HERE, f"loop_{case}.npz"))
        cones = [tuple(c) for c in json.loads(str(f["cones"]))]
        n = int(f["n"])
        P, q, A, b = f["P"], f["q"], f["A"], f["b"]
        layout = ConeLayout(cones_collapse(
            [getattr(ct, c)(d) for c, d in cones]))
        fn = jax.jit(jax.vmap(build_solve(
            layout, ct.Settings(kkt_backend="ldl"), n, p_nonzero=True)))
        ref = f["ref_ldl_status"]
        for seed in (7, 8, 9):
            qj = q * (1 + 1e-15 * np.random.default_rng(seed).standard_normal(
                q.shape))
            st = np.asarray(jax.device_get(fn(P, qj, A, b))["status"])
            moved = np.nonzero(st != ref)[0]
            print(f"{case} ldl, q*(1+1e-15*xi) draw {seed}: statuses move on "
                  f"lanes {moved.tolist()} ({ref[moved].tolist()} -> "
                  f"{st[moved].tolist()}); SOLVED {(st == 1).sum()} against "
                  f"{(ref == 1).sum()}", flush=True)


def wide_floor():
    import json

    import numpy as np

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct

    f = np.load(os.path.join(HERE, "loop_wide.npz"))
    cones = [tuple(c) for c in json.loads(str(f["cones"]))]
    P, q, A, b = f["P"], f["q"], f["A"], f["b"]
    bs = ct.BatchSolver([getattr(ct, c)(d) for c, d in cones], int(f["n"]),
                        ct.Settings.throughput(dense_ldl_diag_order=False))
    ref = f["ref_throughput_status"]
    for seed in (7, 8, 9):
        for rel in (1e-15, 1e-7):
            qj = q * (1 + rel * np.random.default_rng(seed).standard_normal(
                q.shape))
            st = bs.solve(P, qj, A, b).status
            moved = np.nonzero(st != ref)[0]
            print(f"wide throughput, q*(1+{rel:.0e}*xi) draw {seed}: "
                  f"statuses move on lanes {moved.tolist()} "
                  f"({ref[moved].tolist()} -> {st[moved].tolist()}); SOLVED "
                  f"{(st == 1).sum()} against {(ref == 1).sum()}", flush=True)


def main(argv):
    for part in argv or ["x", "floor", "wide"]:
        {"x": x_spread, "floor": status_floor, "wide": wide_floor}[part]()


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
