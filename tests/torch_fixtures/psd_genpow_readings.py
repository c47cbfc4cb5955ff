"""What the port reads against the committed JAX fixtures of PSD-triangle
and generalized power cones (`loop_psd_genpow.npz`,
`megakernel_{psd2,psd_zero,genpow}.npz`): SOLVED, ALMOST_SOLVED and
MAX_ITERATIONS counts, lanes ending on the Dual strategy, and on the lanes
both solve the largest |dobj|, |dx| and iteration difference.  The port
runs on the CPU: the loop with the fixture's backend, and the plain K1d
and K1c for the megakernel cases (side 3 held against the loop fixture).
Imports the port and numpy only.  Run from the repository root:

    python tests/torch_fixtures/psd_genpow_readings.py
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def describe(tag, out, ref):
    import numpy as np

    st, rs = out["status"], ref["status"]
    both = (st == 1) & (rs == 1)
    dobj = np.abs(out["obj_val"] - ref["obj_val"])[both]
    dx = np.abs(out["x"] - ref["x"])[both]
    dit = np.abs(out["iterations"].astype(int) - ref["iterations"])[both]
    print(f"{tag}: SOLVED/ALMOST/MAX_ITERATIONS port {(st == 1).sum()}/"
          f"{(st == 4).sum()}/{(st == 7).sum()}, reference "
          f"{(rs == 1).sum()}/{(rs == 4).sum()}/{(rs == 7).sum()} of "
          f"{len(st)}; port lanes ending on Dual "
          f"{int((out['scaling'] == 1).sum())}; on the {both.sum()} lanes "
          f"both solve: max|dobj| {dobj.max():.2e}, max|dx| {dx.max():.2e}, "
          f"max iteration difference {dit.max()}, mean iterations port "
          f"{out['iterations'].mean():.3f} reference "
          f"{ref['iterations'].mean():.3f}")


def main():
    import numpy as np

    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.interop import cone_from_tuple
    from clarabel_tpu_torch.ipm import megakernel, megakernel_ref
    import make_psd_genpow_fixtures as fx

    torch.set_num_threads(1)
    keys = ("x", "status", "obj_val", "iterations")

    def port(cones, n, backend, P, q, A, b):
        bs = ctt.BatchSolver([cone_from_tuple(tuple(c)) for c in cones], n,
                             ctt.Settings(kkt_backend=backend),
                             device="cpu")
        sol = bs.solve(P, q, A, b)
        out = {k: np.asarray(getattr(sol, k)) for k in keys}
        if bs._mega_fn is not None:
            spec = bs._mega_fn.spec
            _, flats = megakernel.prepare(P, q, A, b, spec, "cpu")
            out["scaling"] = megakernel_ref.mega_solve_plain(
                *flats, spec, len(q))[1][2].numpy()
        else:
            out["scaling"] = np.asarray(sol._out["scaling"])
        return out

    f = np.load(os.path.join(HERE, "loop_psd_genpow.npz"))
    for case in fx.LOOP_CASES:
        cones, n, P, q, A, b = fx.case_inputs(case, fx.LOOP_B)
        for backend in fx.BACKENDS:
            ref = {k: f[f"{case}_{backend}_{k}"] for k in keys}
            describe(f"loop {case} {backend}",
                     port(cones, n, backend, P, q, A, b), ref)
        if case == "psd3":
            ref = {k: f[f"psd3_condensed_{k}"] for k in keys}
            describe("plain K1d psd3 vs the JAX condensed loop",
                     port(cones, n, "megakernel", P, q, A, b), ref)
    for name in ("psd2", "psd_zero", "genpow"):
        g = np.load(os.path.join(HERE, f"megakernel_{name}.npz"))
        cones = json.loads(str(g["cones"]))
        out = port(cones, int(g["n"]), "megakernel", g["P"], g["q"],
                   g["A"], g["b"])
        describe(f"plain K1{'c' if name == 'genpow' else 'd'} {name} vs the "
                 f"JAX megakernel", out, {k: g["ref_" + k] for k in keys})
        describe(f"plain K1{'c' if name == 'genpow' else 'd'} {name} vs the "
                 f"JAX loop", out, {k: g["loop_" + k] for k in keys})


if __name__ == "__main__":
    main()
