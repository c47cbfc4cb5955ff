"""What the port reads against the committed JAX fixtures of exponential and
power cones (`loop_nonsym.npz`, `megakernel_{exp,pow,switch}.npz`): SOLVED
and ALMOST_SOLVED counts, lanes ending on the Dual strategy, and on the
lanes both solve the largest |dobj|, |dx| and iteration difference.  The
port runs on the CPU (the plain K1b for the megakernel cases); the 8-lane
loop batches come from tests/test_megakernel_nonsym.py, which imports the
JAX package.  Run from the repository root:

    python tests/torch_fixtures/nonsym_readings.py
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def describe(tag, out, ref, dual):
    import numpy as np

    both = (out["status"] == 1) & (ref["status"] == 1)
    dobj = np.abs(out["obj_val"] - ref["obj_val"])[both]
    dx = np.abs(out["x"] - ref["x"])[both]
    dit = np.abs(out["iterations"].astype(int) - ref["iterations"])[both]
    print(f"{tag}: SOLVED/ALMOST port {(out['status'] == 1).sum()}/"
          f"{(out['status'] == 4).sum()}, reference "
          f"{(ref['status'] == 1).sum()}/{(ref['status'] == 4).sum()} of "
          f"{len(both)}; port lanes ending on Dual {dual}; on the "
          f"{both.sum()} lanes both solve: max|dobj| {dobj.max():.2e}, "
          f"max|dx| {dx.max():.2e}, max iteration difference {dit.max()}, "
          f"mean iterations port {out['iterations'].mean():.3f} reference "
          f"{ref['iterations'].mean():.3f}")


def main():
    import numpy as np

    for p in (ROOT, os.path.join(ROOT, "tests")):
        sys.path.insert(0, p)
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.interop import cone_from_tuple
    from clarabel_tpu_torch.ipm import megakernel, megakernel_ref

    import make_nonsym_fixtures as script   # noqa: E402 (beside this file)

    f = np.load(os.path.join(HERE, "loop_nonsym.npz"))
    for case, backend in script.LOOP_CASES:
        cones, n, over, P, q, A, b = script.loop_inputs(case)
        st = ctt.Settings(kkt_backend=backend, **over)
        bs = ctt.BatchSolver([cone_from_tuple(tuple(c)) for c in cones], n,
                             st, device="cpu")
        out = bs.solve(P, q, A, b)._out
        ref = {k: f[f"{case}_{backend}_{k}"] for k in script.OUT_KEYS}
        describe(f"loop {case}/{backend}", out, ref,
                 int((out["scaling"] == 1).sum()))
    for name in ("exp", "pow", "switch"):
        g = np.load(os.path.join(HERE, f"megakernel_{name}.npz"))
        cones = [cone_from_tuple(tuple(c))
                 for c in json.loads(str(g["cones"]))]
        st = ctt.Settings(kkt_backend="megakernel",
                          **json.loads(str(g["settings"])))
        bs = ctt.BatchSolver(cones, int(g["n"]), st, device="cpu")
        P, q, A, b = (g[k] for k in "PqAb")
        out = bs.solve(P, q, A, b)
        _, flats = megakernel.prepare(P, q, A, b, bs._mega_fn.spec, "cpu")
        _, ints = megakernel_ref.mega_solve_plain(*flats, bs._mega_fn.spec,
                                                  len(q))
        ref = {k[4:]: g[k] for k in g.files if k.startswith("ref_")}
        describe(f"megakernel {name}", {k: getattr(out, k) for k in
                                        ("status", "obj_val", "x",
                                         "iterations")}, ref,
                 int((ints[2] == 1).sum()))


if __name__ == "__main__":
    main()
