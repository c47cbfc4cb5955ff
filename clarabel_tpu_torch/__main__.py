"""Command-line entry point: solve a problem file.

    python -m clarabel_tpu_torch problem.qps [--max-iter N] [--tol 1e-8]
                                             [--backend auto] [--timing]
                                             [--quiet] [--device cpu]

Supports .qps/.mps (Maros–Mészáros QPS), .cbf (CBLIB), and .json
(the reference's JSON schema, io/json_io.py).  The port's copy of the JAX
package's `__main__.py` with `--device`: the solve runs on the card unless
`--device cpu` is given; with no card and no `--device cpu` it exits
non-zero with the reason and does not move to the CPU on its own.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="clarabel_tpu_torch",
                                 description="conic IPM solver (PyTorch)")
    ap.add_argument("file", help="problem file (.qps/.mps, .cbf, .json)")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None,
                    help="gap/feas tolerance (default 1e-8)")
    ap.add_argument("--backend", default=None,
                    help="kkt backend: auto|ldl|condensed|blockarrow|"
                         "multifrontal")
    ap.add_argument("--timing", action="store_true",
                    help="phase-resolved timers")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the plain versions of the kernels)")
    args = ap.parse_args(argv)

    from . import Solver, Settings
    from .parallel.batch_impl import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"clarabel_tpu_torch: {e}", file=sys.stderr)
        return 2

    kw = {}
    if args.max_iter is not None:
        kw["max_iter"] = args.max_iter
    if args.tol is not None:
        kw.update(tol_gap_abs=args.tol, tol_gap_rel=args.tol,
                  tol_feas=args.tol)
    if args.backend is not None:
        kw["kkt_backend"] = args.backend
    if args.timing:
        kw["timing"] = True
    kw["verbose"] = not args.quiet
    settings = Settings(**kw)

    fname = args.file.lower()
    obj_constant = 0.0
    if fname.endswith((".qps", ".mps")):
        from .io.qps import load_qps

        prob = load_qps(args.file)
        solver = Solver(prob.P, prob.q, prob.A, prob.b, prob.cones,
                        settings, device=device)
        obj_constant = prob.obj_constant
    elif fname.endswith(".cbf"):
        from .io.cbf import load_cbf

        prob = load_cbf(args.file)
        solver = Solver(prob.P, prob.q, prob.A, prob.b, prob.cones,
                        settings, device=device)
        obj_constant = prob.obj_constant
    elif fname.endswith(".json"):
        from .io.json_io import load_from_file

        solver = load_from_file(args.file, settings=settings, device=device)
    else:
        ap.error(f"unrecognized problem file extension: {args.file}")

    sol = solver.solve()
    if args.timing:
        solver.print_timers()
    print(f"status={sol.status.name} iters={sol.iterations} "
          f"obj={sol.obj_val + obj_constant:.9e} "
          f"r_prim={sol.r_prim:.2e} r_dual={sol.r_dual:.2e} "
          f"time={sol.solve_time:.3f}s")
    return 0 if sol.status.name.startswith(("SOLVED", "ALMOST")) else 1


if __name__ == "__main__":
    sys.exit(main())
