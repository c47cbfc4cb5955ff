"""Make the committed `.npz` fixture of the reference's outputs that
`tests/test_torch_faults.py` holds the port against, for three settings
the port used to refuse:

* `blockarrow`, `multifrontal`: `clarabel_tpu.BatchSolver` with that
  `kkt_backend` on the example batch of `__graft_entry__.py`
  (`bench_data.make_batch(4, 6, 0)`, cones [NN(6), SOC(7)]).  BatchSolver
  passes no structure plan, so the reference runs its dense ldl loop;
* `blocked`: the dense ldl loop on `bench_data.make_large_qp_eq(3)` (n =
  200, cones [Zero(20), NN(300)], N = 520 > 512: the blocked factor);
* `verbose`: the iteration rows `Settings(verbose=True)` prints on
  `bench_data.make_batch(3, 3, 0)`.

Run from the repository root (a few minutes, most of it the JAX compile
of the N = 520 loop):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fault_fixtures.py

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import contextlib
import io
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_KEYS = ("x", "status", "iterations", "obj_val")


def main():
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    import clarabel_tpu as ct
    from clarabel_tpu_torch import bench_data

    out = {}
    bench = [ct.NonnegativeConeT(6), ct.SecondOrderConeT(7)]
    data = bench_data.make_batch(4, 6, 0)
    for bk in ("blockarrow", "multifrontal"):
        sol = ct.BatchSolver(bench, 6, ct.Settings(kkt_backend=bk)).solve(
            *data)
        for k in OUT_KEYS:
            out[f"{bk}_{k}"] = np.asarray(getattr(sol, k))
        print(bk, sol.status, sol.iterations, flush=True)

    P, q, A, b = bench_data.make_large_qp_eq(3)
    big = [ct.ZeroConeT(20), ct.NonnegativeConeT(300)]
    sol = ct.BatchSolver(big, 200, ct.Settings(kkt_backend="ldl")).solve(
        P, q, A, b)
    for k in OUT_KEYS:
        out[f"blocked_{k}"] = np.asarray(getattr(sol, k))
    print("blocked", sol.status, sol.iterations, sol.obj_val, flush=True)

    cones = [ct.NonnegativeConeT(3), ct.SecondOrderConeT(4)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sol = ct.BatchSolver(cones, 3, ct.Settings(verbose=True)).solve(
            *bench_data.make_batch(3, 3, 0))
        jax.effects_barrier()
    rows = [r for r in buf.getvalue().splitlines() if r.strip()]
    out["verbose_rows"] = np.array(rows)
    out["verbose_iterations"] = np.asarray(sol.iterations)
    print(f"verbose: {len(rows)} rows", flush=True)
    np.savez(os.path.join(HERE, "faults.npz"), **out)


if __name__ == "__main__":
    main()
