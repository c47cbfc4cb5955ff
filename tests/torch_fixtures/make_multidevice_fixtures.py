"""Make `multidevice.npz`, the committed fixture that the port's sharded
`Solver` and `BatchSolver` are held to in `tests/test_torch_multidevice.py`.

It runs the reference's sharded solves on an 8-device virtual CPU mesh
(this script sets `--xla_force_host_platform_device_count=8` before it
imports JAX), at the mesh shapes of the port's test:

* `Solver(mesh=tp 4)` on the five problems of
  `tests/test_blockarrow_sharded_ipm.py`: `banded_qp()` ("banded"), the
  multi-scenario SOCP ("socp"), `banded_qp(grid=40, seed=5)` as scipy-sparse
  data with `sparse_data=True` ("sparse"), `banded_qp(grid=11, seed=7)`,
  whose natural plan has 7 blocks ("pad"), and the unstructured n = 8 QP
  ("unstructured");
* `BatchSolver(mesh=dp 4)` on the 16-lane batch of
  `tests/test_batch_sharded.py` ("batch_dp4") and `BatchSolver(mesh=(dp 2,
  tp 2))` on the 8-lane batch of `tests/test_multihost.py`
  ("batch_dp2tp2").

For each case it stores the problem (dense P, q, A, b, the cones as JSON
tuples, the Settings fields it sets) and the reference's outputs: status,
iterations, objective and x (per lane for a batch, with the dual
objective), and for a Solver its plan's block count.  Run from the
repository root (about two minutes):

    python tests/torch_fixtures/make_multidevice_fixtures.py

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
ROOT = os.path.dirname(TESTS)
for _p in (ROOT, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)
OUT = os.path.join(HERE, "multidevice.npz")
SOLVER_CASES = ("banded", "socp", "sparse", "pad", "unstructured")
BATCH_CASES = ("batch_dp4", "batch_dp2tp2")


def _tuples(cones):
    from clarabel_tpu_torch.interop import cone_to_tuple

    return [cone_to_tuple(c) for c in cones]


def socp_problem():
    """test_sharded_ipm_socp's multi-scenario SOCP: scenario blocks
    coupled through a few shared variables."""
    import clarabel_tpu as ct

    rng = np.random.default_rng(3)
    n_shared, n_loc, S = 3, 4, 6
    n = n_shared + S * n_loc
    P = np.zeros((n, n))
    P[:n_shared, :n_shared] = np.eye(n_shared)
    for s in range(S):
        o = n_shared + s * n_loc
        F = rng.standard_normal((n_loc, n_loc)) / 2
        P[o:o + n_loc, o:o + n_loc] = F @ F.T + np.eye(n_loc)
    q = rng.standard_normal(n) * 0.1
    rows, bs, cones = [], [], []
    for s in range(S):
        o = n_shared + s * n_loc
        Asoc = np.zeros((n_loc + 1, n))
        Asoc[0, 0] = -1.0
        for i in range(n_loc):
            Asoc[1 + i, o + i] = -1.0
        rows.append(Asoc)
        bs.append(np.concatenate([[2.0], np.zeros(n_loc)]))
        cones.append(ct.SecondOrderConeT(n_loc + 1))
    return P, q, np.vstack(rows), np.concatenate(bs), cones


def solver_problems():
    """name -> (P, q, A, b, cones, settings fields), dense arrays and the
    reference's cone classes."""
    import clarabel_tpu as ct
    from test_blockarrow_backend import banded_qp

    out = {"banded": banded_qp() + ({},),
           "socp": socp_problem() + ({},),
           "sparse": banded_qp(grid=40, seed=5) + ({"sparse_data": True},),
           "pad": banded_qp(grid=11, seed=7) + ({},)}
    rng = np.random.default_rng(1)
    n = 8
    F = rng.standard_normal((n, n))
    out["unstructured"] = (F @ F.T + np.eye(n), rng.standard_normal(n),
                           -np.eye(n), np.ones(n) * 5,
                           [ct.NonnegativeConeT(n)], {})
    return out


def batch_problems():
    """name -> (P, q, A, b, cones, mesh shape) of the two sharded
    batches."""
    import clarabel_tpu as ct
    from test_batch import make_random_socp

    out = {}
    for name, seed, B, shape in (("batch_dp4", 11, 16, (4, 1)),
                                 ("batch_dp2tp2", 5, 8, (2, 2))):
        rng = np.random.default_rng(seed)
        n = 5
        probs = [make_random_socp(rng, n) for _ in range(B)]
        out[name] = tuple(np.stack([p[i] for p in probs])
                          for i in range(4)) + (
            [ct.NonnegativeConeT(n), ct.SecondOrderConeT(n + 1)], shape)
    return out


def main():
    import jax
    import scipy.sparse as sp
    from jax.sharding import Mesh

    import clarabel_tpu as ct
    from clarabel_tpu.parallel.batch_impl import BatchSolver

    devices = np.array(jax.devices()[:8])
    tp4 = Mesh(devices[:4], axis_names=("tp",))
    arrays = {}
    for name, (P, q, A, b, cones, st) in solver_problems().items():
        Pin, Ain = (sp.csr_matrix(P), sp.csr_matrix(A)) if st else (P, A)
        solver = ct.Solver(Pin, q, Ain, b, cones, ct.Settings(**st),
                           mesh=tp4)
        sol = solver.solve()
        arrays.update({f"{name}_P": P, f"{name}_q": q, f"{name}_A": A,
                       f"{name}_b": b,
                       f"{name}_cones": json.dumps(_tuples(cones)),
                       f"{name}_settings": json.dumps(st),
                       f"{name}_x": np.asarray(sol.x),
                       f"{name}_status": int(sol.status),
                       f"{name}_iterations": int(sol.iterations),
                       f"{name}_obj_val": float(sol.obj_val),
                       f"{name}_p": int(solver._structure.p),
                       f"{name}_backend": solver._backend})
        print(f"{name}: {sol.status.name} in {sol.iterations} iterations, "
              f"p = {solver._structure.p}, backend {solver._backend}")
    for name, (P, q, A, b, cones, shape) in batch_problems().items():
        mesh = Mesh(devices[:shape[0] * shape[1]].reshape(shape),
                    axis_names=("dp", "tp"))
        out = BatchSolver(cones, q.shape[1], mesh=mesh).solve(P, q, A, b)
        arrays.update({f"{name}_P": P, f"{name}_q": q, f"{name}_A": A,
                       f"{name}_b": b,
                       f"{name}_cones": json.dumps(_tuples(cones)),
                       f"{name}_mesh": np.asarray(shape),
                       f"{name}_x": np.asarray(out.x),
                       f"{name}_status": np.asarray(out.status),
                       f"{name}_iterations": np.asarray(out.iterations),
                       f"{name}_obj_val": np.asarray(out.obj_val),
                       f"{name}_obj_val_dual": np.asarray(
                           out._out["obj_val_dual"])})
        print(f"{name}: statuses {np.asarray(out.status).tolist()}")
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
