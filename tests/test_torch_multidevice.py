"""The port's multi-device paths on the CPU: batch sharding over a "dp"
mesh dim and the block-arrow factorization of one `Solver` sharded over
"tp" (`clarabel_tpu_torch/parallel/`, DEVIATIONS.md #20).

* In this process, with no process group: `pad_plan_blocks` against the
  reference's, array for array; `initialize_distributed()` a no-op without
  the torchrun environment; a mesh that is not a DeviceMesh refused.
* One world of 4 gloo ranks (`parallel.dryrun.launch`, a `file://`
  rendezvous under tmp_path, one thread a rank, 180 s to join), each rank
  writing its results to tmp_path for this process to assert:
  - `BlockArrowKKT` on tp = 4 against a dense solve, relative error
    1e-10 (the cases of tests/test_schur_multichip.py);
  - `Solver(mesh=tp 4)` on the five problems of
    tests/test_blockarrow_sharded_ipm.py (one of them sparse data, one
    whose 7 natural blocks pad to 8, one unstructured);
  - `BatchSolver` on dp = 4 (16 lanes) and on (dp, tp) = (2, 2) (8 lanes);
  - `make_solver_mesh`'s shapes and errors, and `dryrun_multichip`.
  Against the port's unsharded solves: statuses and iterations equal, x
  within 1e-8 relative for the Solver (the reference's own bar,
  tests/test_blockarrow_sharded_ipm.py:40-43) and x and the objective
  within 1e-9 for the BatchSolver (tests/test_batch_sharded.py:29-31).
  Against the reference's sharded solves at the same mesh shapes
  (tests/torch_fixtures/multidevice.npz, `make_multidevice_fixtures.py`;
  its live regeneration is marked slow): status equal, iterations within
  4, x and the objective within 1e-6 (relative to max(1, |·|∞)), and the
  true-KKT residuals (2-norms) of the port's own output below 1e-7.
* On a card (marked gpu): a world of one rank over NCCL, in which the
  sharded Solver (its IPM pass graphed) and BatchSolver give the
  unsharded solves' bits, and the dryrun.  Run them there with
  `python -m pytest --noconftest -m gpu tests/test_torch_multidevice.py`.
"""

import contextlib
import json
import os
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.interop import cone_from_tuple
from clarabel_tpu_torch.parallel import multihost
from clarabel_tpu_torch.parallel.dryrun import launch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
FIX = np.load(os.path.join(FIXTURES, "multidevice.npz"))
SOLVER_CASES = ("banded", "socp", "sparse", "pad", "unstructured")
BATCH_CASES = ("batch_dp4", "batch_dp2tp2")
# (p, nb, nt, matrix seed, right-hand side seed), tests/test_schur_multichip
SCHUR_CASES = ((8, 12, 6, 0, 1), (16, 8, 4, 2, 3))
WORLD, JOIN_S = 4, 180
TOL, KKT_TOL, IT_TOL = 1e-6, 1e-7, 4
SOLVED = int(ctt.SolverStatus.SOLVED)


def load_problem(name):
    """(P, q, A, b, cones, settings) of a fixture case; a case with
    sparse_data=True passes P and A as scipy-sparse."""
    st = json.loads(str(FIX[f"{name}_settings"])) \
        if f"{name}_settings" in FIX else {}
    P, A = FIX[f"{name}_P"], FIX[f"{name}_A"]
    if st.get("sparse_data"):
        P, A = sp.csr_matrix(P), sp.csr_matrix(A)
    cones = [cone_from_tuple(tuple(c))
             for c in json.loads(str(FIX[f"{name}_cones"]))]
    return P, FIX[f"{name}_q"], A, FIX[f"{name}_b"], cones, st


def make_blockarrow(p, nb, nt, seed):
    """tests/test_schur_multichip.py's block-arrow system (D, B, C)."""
    rng = np.random.default_rng(seed)
    D = np.zeros((p, nb, nb))
    Bm = rng.standard_normal((p, nb, nt))
    for i in range(p):
        F = rng.standard_normal((nb, nb))
        D[i] = F @ F.T + nb * np.eye(nb)
    G = rng.standard_normal((nt, nt))
    return D, Bm, G @ G.T + (nt + p * nb) * np.eye(nt)


def dense_assemble(D, Bm, C):
    p, nb, _ = D.shape
    K = np.zeros((p * nb + C.shape[0],) * 2)
    for i in range(p):
        s = slice(i * nb, (i + 1) * nb)
        K[s, s] = D[i]
        K[s, p * nb:] = Bm[i]
        K[p * nb:, s] = Bm[i].T
    K[p * nb:, p * nb:] = C
    return K


def _solution(prefix, sol, solver=None):
    out = {f"{prefix}_{k}": np.asarray(getattr(sol, k))
           for k in ("x", "z", "s", "obj_val", "r_prim", "r_dual")}
    out[f"{prefix}_status"] = int(sol.status)
    out[f"{prefix}_iterations"] = int(sol.iterations)
    if solver is not None:
        out[f"{prefix}_p"] = int(solver._structure.p)
        out[f"{prefix}_backend"] = solver._backend
    return out


def _world_rank(rank, world, out_dir):
    """One rank of the 4-rank world: every sharded case, this rank's share
    of the unsharded ones, written to out_dir/rank{rank}.npz."""
    from torch.distributed.device_mesh import DeviceMesh

    from clarabel_tpu_torch.entry import dryrun_multichip
    from clarabel_tpu_torch.parallel.schur import BlockArrowKKT

    res = {}
    ranks = torch.arange(world)
    tp = DeviceMesh("cpu", ranks, mesh_dim_names=("tp",))
    for i, (p, nb, nt, seed, rseed) in enumerate(SCHUR_CASES):
        kkt = BlockArrowKKT(tp, p, nb, nt, device="cpu")
        res[f"schur{i}_ok"] = kkt.factor(*make_blockarrow(p, nb, nt, seed))
        rng = np.random.default_rng(rseed)
        x, y = kkt.solve(rng.standard_normal((p, nb)),
                         rng.standard_normal(nt))
        res[f"schur{i}_sol"] = np.concatenate([x.reshape(-1), y])

    for name in SOLVER_CASES:
        P, q, A, b, cones, st = load_problem(name)
        solver = ctt.Solver(P, q, A, b, cones, ctt.Settings(**st), mesh=tp,
                            device="cpu")
        res.update(_solution(name, solver.solve(), solver))
    for name in SOLVER_CASES[rank::world]:
        P, q, A, b, cones, st = load_problem(name)
        solver = ctt.Solver(P, q, A, b, cones,
                            ctt.Settings(kkt_backend="blockarrow", **st),
                            device="cpu")
        res.update(_solution(f"unsharded_{name}", solver.solve(), solver))

    meshes = {"batch_dp4": DeviceMesh("cpu", ranks, mesh_dim_names=("dp",)),
              "batch_dp2tp2": multihost.make_solver_mesh(
                  dp=2, tp=2, device_type="cpu")}
    for i, name in enumerate(BATCH_CASES):
        P, q, A, b, cones, _ = load_problem(name)
        for tag, mesh in ((name, meshes[name]),
                          (f"unsharded_{name}", None)):
            if mesh is None and rank != i:
                continue
            out = ctt.BatchSolver(cones, q.shape[1], mesh=mesh,
                                  device="cpu").solve(P, q, A, b)
            res.update({f"{tag}_{k}": getattr(out, k) for k in
                        ("x", "z", "s", "status", "obj_val", "iterations")})
            res[f"{tag}_obj_val_dual"] = out._out["obj_val_dual"]

    m22 = meshes["batch_dp2tp2"]
    res["mesh22"] = json.dumps([list(m22.shape), list(m22.mesh_dim_names)])
    res["mesh_tp1"] = json.dumps(list(multihost.make_solver_mesh(
        tp=1, device_type="cpu").shape))
    refused = []
    for kw in ({"dp": 16, "tp": 2}, {"tp": 3}):
        try:
            multihost.make_solver_mesh(device_type="cpu", **kw)
        except ValueError:
            refused.append(kw)
    res["mesh_refused"] = json.dumps(refused)
    res["report"] = multihost.mesh_placement_report(m22)
    res["dryrun"] = dryrun_multichip(device="cpu")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The results of the 4-rank gloo world, rank by rank, with the
    unsharded solves merged into every rank's dict under `unsharded_*`."""
    out = tmp_path_factory.mktemp("world")
    codes = launch(_world_rank, WORLD, "gloo", "cpu", (str(out),),
                   timeout=JOIN_S)
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    unsharded = {k: v for rk in ranks for k, v in rk.items()
                 if k.startswith("unsharded_")}
    for rk in ranks:
        rk.update(unsharded)
    return ranks


def true_kkt(P, q, A, b, x, z, s):
    P, A = sp.csr_matrix(P), sp.csr_matrix(A)
    return (np.linalg.norm(A @ x + s - b),
            np.linalg.norm(P @ x + q + A.T @ z))


# ---- in this process, no process group ----

def _plans():
    from clarabel_tpu_torch.cones.layout import ConeLayout
    from clarabel_tpu_torch.structure import analyze_block_arrow

    for name, multiple in (("banded", 3), ("pad", 4), ("unstructured", 8)):
        P, q, A, b, cones, _ = load_problem(name)
        yield name, multiple, analyze_block_arrow(
            np.asarray(P) != 0, np.asarray(A) != 0, ConeLayout(cones))


@pytest.mark.parametrize("case", ["banded", "pad", "unstructured"])
def test_pad_plan_blocks_matches_the_reference(case):
    """The port's padded plan equals the reference's, array for array,
    each padded from the same natural plan."""
    import dataclasses

    from clarabel_tpu import structure as ref_structure
    from clarabel_tpu_torch.structure import pad_plan_blocks

    name, multiple, plan = next(c for c in _plans() if c[0] == case)
    fields = {f.name: getattr(plan, f.name)
              for f in dataclasses.fields(plan)}
    want = ref_structure.pad_plan_blocks(
        ref_structure.BlockArrowPlan(**fields), multiple)
    got = pad_plan_blocks(plan, multiple)
    assert got.p % multiple == 0 and got.p > plan.p or plan.p % multiple == 0
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b
    assert got.key == pad_plan_blocks(got, multiple).key


def test_initialize_distributed_without_environment(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is False
    assert multihost.initialize_distributed(world_size=1) is False


@pytest.mark.parametrize("make", ["Solver", "BatchSolver", "BlockArrowKKT"])
def test_a_mesh_that_is_not_a_device_mesh_raises(make):
    from clarabel_tpu_torch.parallel.schur import BlockArrowKKT

    P, q, A, b, cones, _ = load_problem("banded")
    with pytest.raises(TypeError, match="DeviceMesh"):
        if make == "Solver":
            ctt.Solver(P, q, A, b, cones, mesh=object(), device="cpu")
        elif make == "BatchSolver":
            ctt.BatchSolver(cones, q.shape[0], mesh=("dp",), device="cpu")
        else:
            BlockArrowKKT(object(), 8, 4, 2, device="cpu")


# ---- the 4-rank world ----

@pytest.mark.parametrize("case", range(len(SCHUR_CASES)))
def test_block_arrow_kkt_matches_a_dense_solve(world, case):
    p, nb, nt, seed, rseed = SCHUR_CASES[case]
    D, Bm, C = make_blockarrow(p, nb, nt, seed)
    rng = np.random.default_rng(rseed)
    rhs = np.concatenate([rng.standard_normal((p, nb)).reshape(-1),
                          rng.standard_normal(nt)])
    ref = np.linalg.solve(dense_assemble(D, Bm, C), rhs)
    for rk in world:
        assert bool(rk[f"schur{case}_ok"])
        sol = rk[f"schur{case}_sol"]
        assert np.linalg.norm(sol - ref) / np.linalg.norm(ref) < 1e-10


@pytest.mark.parametrize("name", SOLVER_CASES)
def test_sharded_solver_matches_the_unsharded_solve(world, name):
    """tp = 4 against the port's unsharded block-arrow solve of the same
    problem, on every rank; the plan padded to a multiple of 4."""
    for rk in world:
        got = {k[len(name) + 1:]: v for k, v in rk.items()
               if k.startswith(name + "_")}
        ref = {k[len(name) + 11:]: v for k, v in rk.items()
               if k.startswith(f"unsharded_{name}_")}
        assert str(got["backend"]) == "blockarrow"
        assert int(got["p"]) % WORLD == 0
        assert int(got["p"]) >= int(ref["p"])
        assert int(got["status"]) == int(ref["status"]) == SOLVED
        assert int(got["iterations"]) == int(ref["iterations"])
        assert np.linalg.norm(got["x"] - ref["x"]) < 1e-8 * max(
            1.0, np.linalg.norm(ref["x"]))
        assert float(got["r_prim"]) < 1e-8 and float(got["r_dual"]) < 1e-8
    # every rank returns the whole solution, the same one
    for rk in world[1:]:
        np.testing.assert_array_equal(rk[f"{name}_x"], world[0][f"{name}_x"])
    if name == "pad":
        assert int(world[0]["unsharded_pad_p"]) % WORLD != 0


@pytest.mark.parametrize("name", SOLVER_CASES)
def test_sharded_solver_matches_the_reference(world, name):
    """tp = 4 against the reference's tp = 4 solve at ROADMAP's bars."""
    P, q, A, b, _, _ = load_problem(name)
    rk = world[0]
    x = rk[f"{name}_x"]
    assert int(rk[f"{name}_status"]) == int(FIX[f"{name}_status"])
    assert abs(int(rk[f"{name}_iterations"])
               - int(FIX[f"{name}_iterations"])) <= IT_TOL
    assert int(rk[f"{name}_p"]) == int(FIX[f"{name}_p"])
    ref_x = FIX[f"{name}_x"]
    assert np.abs(x - ref_x).max() <= TOL * max(1.0, np.abs(ref_x).max())
    ref_obj = float(FIX[f"{name}_obj_val"])
    assert abs(float(rk[f"{name}_obj_val"]) - ref_obj) <= TOL * max(
        1.0, abs(ref_obj))
    kkt = true_kkt(P, q, A, b, x, rk[f"{name}_z"], rk[f"{name}_s"])
    assert max(kkt) < KKT_TOL, kkt


@pytest.mark.parametrize("name", BATCH_CASES)
def test_sharded_batch_matches_the_unsharded_solve(world, name):
    for rk in world:
        assert np.array_equal(rk[f"{name}_status"],
                              rk[f"unsharded_{name}_status"])
        assert np.array_equal(rk[f"{name}_iterations"],
                              rk[f"unsharded_{name}_iterations"])
        assert np.all(rk[f"{name}_status"] == SOLVED)
        assert np.allclose(rk[f"{name}_x"], rk[f"unsharded_{name}_x"],
                           rtol=0, atol=1e-9)
        assert np.allclose(rk[f"{name}_obj_val"],
                           rk[f"unsharded_{name}_obj_val"], rtol=0,
                           atol=1e-9)


@pytest.mark.parametrize("name", BATCH_CASES)
def test_sharded_batch_matches_the_reference(world, name):
    """The ROADMAP bars, with x held within 1e-6 or within the sum of both
    solutions' certificate radii, as every batched parity test of the port
    holds it (DEVIATIONS.md #4: the 1e-8 termination bounds the gap, not
    the distance to x*)."""
    P, q, A, b, _, _ = load_problem(name)
    rk = world[0]
    np.testing.assert_array_equal(rk[f"{name}_status"],
                                  FIX[f"{name}_status"])
    assert np.abs(rk[f"{name}_iterations"].astype(int)
                  - FIX[f"{name}_iterations"].astype(int)).max() <= IT_TOL
    ref_x, ref_obj = FIX[f"{name}_x"], FIX[f"{name}_obj_val"]
    lam = np.linalg.eigvalsh(P)[:, 0]
    radius = sum(np.sqrt(2.0 * np.abs(obj - dual) / lam) for obj, dual in (
        (rk[f"{name}_obj_val"], rk[f"{name}_obj_val_dual"]),
        (ref_obj, FIX[f"{name}_obj_val_dual"])))
    dx = np.abs(rk[f"{name}_x"] - ref_x).max(axis=1)
    assert (dx <= np.maximum(TOL, radius)).all(), (dx, radius)
    assert (np.abs(rk[f"{name}_obj_val"] - ref_obj)
            <= TOL * np.maximum(1.0, np.abs(ref_obj))).all()
    for i in range(len(q)):
        kkt = true_kkt(P[i], q[i], A[i], b[i], rk[f"{name}_x"][i],
                       rk[f"{name}_z"][i], rk[f"{name}_s"][i])
        assert max(kkt) < KKT_TOL, (i, kkt)


def test_make_solver_mesh_shapes_and_errors(world):
    for rk in world:
        assert json.loads(str(rk["mesh22"])) == [[2, 2], ["dp", "tp"]]
        assert json.loads(str(rk["mesh_tp1"])) == [WORLD, 1]
        assert json.loads(str(rk["mesh_refused"])) == [
            {"dp": 16, "tp": 2}, {"tp": 3}]
        report = str(rk["report"])
        assert "'dp': 2" in report and "'tp': 2" in report


def test_dryrun_at_world_4(world):
    for rk in world:
        line = str(rk["dryrun"])
        assert line.startswith("dryrun_multichip OK on 4 devices"), line
        assert "tp-sharded IPM SOLVED" in line


@pytest.mark.slow
def test_regenerated_fixture_matches():
    """Live regeneration of the reference's tp = 4 banded solve equals the
    committed one."""
    import importlib.util

    import jax
    from jax.sharding import Mesh

    import clarabel_tpu as ct

    spec = importlib.util.spec_from_file_location(
        "make_multidevice_fixtures",
        os.path.join(FIXTURES, "make_multidevice_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    P, q, A, b, cones, st = mod.solver_problems()["banded"]
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("tp",))
    sol = ct.Solver(P, q, A, b, cones, ct.Settings(**st), mesh=mesh).solve()
    np.testing.assert_array_equal(np.asarray(sol.x), FIX["banded_x"])
    assert int(sol.iterations) == int(FIX["banded_iterations"])


# ---- on a card: a world of one rank over NCCL ----

@contextlib.contextmanager
def world_of_one(backend, device_type, dims=("dp", "tp")):
    """A default process group of this process alone (a `file://`
    rendezvous in a temporary directory) and a mesh of size 1 on each of
    `dims`; the group is destroyed on leaving."""
    import torch.distributed as dist

    from torch.distributed.device_mesh import DeviceMesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend,
                                init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            yield DeviceMesh(device_type,
                             torch.zeros((1,) * len(dims), dtype=torch.int64),
                             mesh_dim_names=dims)
        finally:
            dist.destroy_process_group()


@pytest.fixture
def nccl_world_of_one():
    """A world of one rank over NCCL on card 0, with a ("dp", "tp") mesh
    of (1, 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    with world_of_one("nccl", "cuda") as mesh:
        yield mesh


@pytest.mark.gpu
@pytest.mark.parametrize("name", SOLVER_CASES)
def test_world_of_one_solver_gives_the_unsharded_bits(nccl_world_of_one,
                                                      name):
    P, q, A, b, cones, st = load_problem(name)
    sharded = ctt.Solver(P, q, A, b, cones, ctt.Settings(**st),
                         mesh=nccl_world_of_one)
    assert sharded._solve_fn.graphed
    got = sharded.solve()
    ref = ctt.Solver(P, q, A, b, cones,
                     ctt.Settings(kkt_backend="blockarrow", **st)).solve()
    assert got.status == ref.status and got.iterations == ref.iterations
    np.testing.assert_array_equal(got.x, ref.x)
    assert sharded._solve_fn.counts["replays"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", BATCH_CASES)
def test_world_of_one_batch_gives_the_unsharded_bits(nccl_world_of_one,
                                                     name):
    P, q, A, b, cones, _ = load_problem(name)
    st = ctt.Settings.throughput()
    got = ctt.BatchSolver(cones, q.shape[1], st,
                          mesh=nccl_world_of_one).solve(P, q, A, b)
    ref = ctt.BatchSolver(cones, q.shape[1], st).solve(P, q, A, b)
    for k in ("status", "iterations", "x", "obj_val"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


@pytest.mark.gpu
def test_world_of_one_dryrun(nccl_world_of_one):
    from clarabel_tpu_torch.entry import dryrun_multichip

    assert dryrun_multichip().startswith("dryrun_multichip OK on 1 devices")
