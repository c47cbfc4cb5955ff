"""Print what the port's float32 first phase (K1e's plain version on the
CPU) reads against the JAX megakernel's two-phase fixtures
(`make_two_phase_fixtures.py`): statuses, and on the lanes both solve the
largest differences in x, in the objective (relative) and in iterations,
beside the same readings of both packages' single phase.

    python tests/torch_fixtures/two_phase_readings.py            # fixtures
    JAX_PLATFORMS=cpu python tests/torch_fixtures/two_phase_readings.py live

`live` also solves the 16 lanes of `tests/test_megakernel.py`
`_batch(16, seed=3)` with the JAX megakernel, two-phase and single-phase
(about two minutes of compiling), and prints each lane's status and
iterations in both packages.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import clarabel_tpu_torch as ctt  # noqa: E402
from clarabel_tpu_torch.interop import cone_from_tuple  # noqa: E402

SOLVED = int(ctt.SolverStatus.SOLVED)


def port(cones, n, two_phase, data):
    st = ctt.Settings(kkt_backend="megakernel",
                      megakernel_two_phase=two_phase)
    return ctt.BatchSolver(cones, n, st, device="cpu").solve(*data)


def reading(sol, ref):
    both = (sol.status == SOLVED) & (ref["status"] == SOLVED)
    dx = np.abs(sol.x - ref["x"]).max(axis=1)[both]
    dobj = (np.abs(sol.obj_val - ref["obj_val"])
            / (1 + np.abs(ref["obj_val"])))[both]
    dit = np.abs(sol.iterations - ref["iterations"])[both]
    return (f"SOLVED {int((sol.status == SOLVED).sum())} (JAX "
            f"{int((ref['status'] == SOLVED).sum())}), statuses "
            f"{np.bincount(sol.status, minlength=11).tolist()} (JAX "
            f"{np.bincount(ref['status'], minlength=11).tolist()}); on the "
            f"{int(both.sum())} lanes both solve: max|dx| "
            f"{dx.max(initial=0):.2e}, max|dobj|/(1+|obj|) "
            f"{dobj.max(initial=0):.2e}, iterations equal on "
            f"{int((dit == 0).sum())}, max diff {dit.max(initial=0)}")


def fixtures():
    for name in ("tiny", "bench", "psd2"):
        f = np.load(os.path.join(HERE, f"two_phase_{name}.npz"))
        cones = [cone_from_tuple(tuple(c))
                 for c in json.loads(str(f["cones"]))]
        n, data = int(f["n"]), (f["P"], f["q"], f["A"], f["b"])
        for tag, two_phase in (("ref_", True), ("single_", False)):
            ref = {k[len(tag):]: f[k] for k in f.files if k.startswith(tag)}
            sol = port(cones, n, two_phase, data)
            p1 = sol._out["p1_iterations"]
            print(f"{name} {'two-phase' if two_phase else 'single'}: "
                  f"{reading(sol, ref)}; phase-1 iterations mean "
                  f"{p1.mean():.3f}, range {int(p1.min())}-{int(p1.max())}",
                  flush=True)


def live():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import clarabel_tpu as ct
    from make_two_phase_fixtures import tiny_batch

    data = tiny_batch(16, seed=3, infeasible_every=None)
    cones = [ct.NonnegativeConeT(2), ct.SecondOrderConeT(2)]
    pcones = [ctt.NonnegativeConeT(2), ctt.SecondOrderConeT(2)]
    for two_phase in (True, False):
        st = ct.Settings(kkt_backend="megakernel",
                         megakernel_two_phase=two_phase)
        ref = ct.BatchSolver(cones, 2, st).solve(*data)
        sol = port(pcones, 2, two_phase, data)
        print(f"_batch(16, seed=3) {'two-phase' if two_phase else 'single'}"
              f": JAX statuses {ref.status.tolist()}, iterations "
              f"{ref.iterations.tolist()}; port statuses "
              f"{sol.status.tolist()}, iterations "
              f"{sol.iterations.tolist()}", flush=True)


if __name__ == "__main__":
    fixtures()
    if sys.argv[1:] == ["live"]:
        live()
