"""The harness end to end on the CPU (the program's plain versions) at a
small size: a cell added as data files alone runs; a planted fault under
the window makes `correct` false; nothing JAX is imported; the trace's
reduction and the readers' arithmetic.  Runs go through subprocesses, so
that no module another test imported can leak into the check of
`sys.modules`."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness, trace

REPO = harness.ROOT
PB = os.path.join(REPO, "portbench")
FAULTS = ("unchanged", "half", "altered", "status", "unsolved")
# the runs are small; one thread each keeps parallel test workers apart
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1")


def tiny_root(tmp_path, base_cell, batch=64, changes=None, extra=None):
    """A checkout-like root holding a copy of portbench/ and a
    BENCHMARK.json with one more cell, `tiny`, added as data files only:
    its traffic (`base_cell`'s, with `changes`: a dict of traffic keys
    and, under "limits", the cell file's limits), its cell file (the
    limits of `base_cell` unless changed) and, with `extra`, a per-layer
    metric of its own."""
    root = tmp_path / "root"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    base = harness.load_cell(REPO, base_cell)
    wl = [w for w in bench["workloads"] if w["name"] == base_cell][0]
    changes = dict(changes or {})
    limits = changes.pop("limits", base.limits)
    traffic = dict(base.traffic, batch=batch, pool=2, warmup_calls=1,
                   sample_lanes=16, reference_block=64, **changes)
    (root / "portbench" / "traffic" / "tiny_traffic.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "workloads" / "tiny.json").write_text(
        json.dumps({"limits": limits}))
    bench["workloads"].append(dict(wl, name="tiny", traffic="tiny_traffic"))
    if extra:
        (root / "portbench" / "metrics" / "lanes_per_call.py").write_text(
            "def read(run):\n    return run.lanes / len(run.walls)\n")
        bench["per_layer"].append(
            {"name": "lanes_per_call", "unit": "lanes", "better": "higher",
             "source": "program_counter", "layer": "device",
             "moves": "solves_per_s", "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root, trace_flag=0, fault=None, seconds=0.5):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from portbench import harness\n"
        "from portbench.tests import test_pb_harness as t\n"
        f"wrap = t.fault_wrapper({fault!r}) if {fault!r} else None\n"
        f"rc = harness.main(['--workload', 'tiny', '--seed', '4000000007', "
        f"'--seconds', '{seconds}', '--trace', '{trace_flag}'], "
        f"root={str(root)!r}, device='cpu', wrap_solve=wrap)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=ONE_THREAD)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr


def fault_wrapper(kind):
    """A fault planted where the answers are produced."""
    import clarabel_tpu_torch as ctt

    def wrap(solve):
        def broken(*args):
            sol = solve(*args)
            x = np.array(sol.x, dtype=np.float64)
            status = np.array(sol.status)
            B = len(status)
            if kind == "unchanged":      # every lane left at the start
                x[:] = 0.0
            elif kind == "half":         # half the lanes never solved,
                x[B // 2:] = x[:B - B // 2]        # given others' answers
                status[B // 2:] = status[:B - B // 2]
            elif kind == "altered":      # every answer changed a little
                x *= 1.0 + 1e-3
            elif kind == "status":       # a certificate on a feasible lane
                status[0] = int(ctt.SolverStatus.PRIMAL_INFEASIBLE)
            elif kind == "unsolved":     # no lane solved: nothing is shown
                status[:] = int(ctt.SolverStatus.MAX_ITERATIONS)
            return types.SimpleNamespace(x=x, status=status,
                                         iterations=sol.iterations)
        return broken
    return wrap


# The megakernel cell's traffic, on the CPU through the megakernel's plain
# version; and the same family at the float32 tier (Settings.throughput(),
# the dense ldl loop) with the limits its cell was held to when the
# benchmark had one (PERF.md section 7).
FLOAT32_LIMITS = {"obj_gap": 6e-03, "infeas": 1.5e-04, "wrong_status": 0,
                  "ref_unsolved": 0}
CELLS = [("socp_n6.b131072",
          {"settings_overrides": {"kkt_backend": "megakernel"}}),
         ("socp_n6.b131072",
          {"settings": "throughput", "precision": "float32",
           "limits": FLOAT32_LIMITS})]
CELL_IDS = ["megakernel", "float32_loop"]


@pytest.mark.parametrize("cell,changes", CELLS, ids=CELL_IDS)
def test_data_only_cell_runs_and_is_correct(tmp_path, cell, changes):
    root = tiny_root(tmp_path, cell, changes=changes, extra=True)
    for flag in (0, 1):
        result, modules, err = run_tiny(root, flag)
        assert result["correct"], err[-2000:]
        assert result["attempted"] > 0
        assert list(result)[-1] == "checks"
        assert "check obj_gap" in err.strip().splitlines()[-5]
        assert not set(modules) & set(harness.FORBIDDEN)
        names = set(result["metrics"])
        if flag:
            assert {"ipm_iters_mean", "lanes_per_call"} <= names
            # no device numbers from a CPU run
            assert "busy_s" not in result["device"]
            assert "device_idle_pct" not in names
        else:
            assert {"solves_per_s", "setup_s"} <= names


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell,changes", CELLS, ids=CELL_IDS)
def test_planted_fault_is_not_correct(tmp_path, cell, changes, fault):
    root = tiny_root(tmp_path, cell, changes=changes)
    result, _, err = run_tiny(root, fault=fault)
    assert result["correct"] is False, err[-2000:]


# A family of another cone kind, bench.py's equality-constrained QP
# (min 1/2 x'Px + q'x s.t. sum x = 1, x <= ub, -sum x <= 0.5: a zero cone
# and a nonnegative one), landed as a configuration with its own generator
# and reference: the reference solves each lane by SLSQP and measures
# zero-cone rows by |s|, which the shared judge knows nothing of.
EQ_GENERATOR = """
import numpy as np


def make_pool(B, n, count, seed, device):
    pool = []
    for k in range(count):
        rng = np.random.default_rng([seed % 2 ** 64, k])
        F = rng.standard_normal((B, n, n)) / np.sqrt(n)
        P = F @ F.transpose(0, 2, 1) + 0.5 * np.eye(n)
        P = 0.5 * (P + P.transpose(0, 2, 1))
        q = rng.standard_normal((B, n))
        A = np.zeros((B, n + 2, n))
        A[:, 0], A[:, 1:n + 1], A[:, n + 1] = 1.0, np.eye(n), -1.0
        b = np.concatenate([np.ones((B, 1)), rng.uniform(0.5, 1.5, (B, n)),
                            np.full((B, 1), 0.5)], axis=1)
        pool.append((P, q, A, b))
    return pool
"""
EQ_REFERENCE = """
import numpy as np
import torch
from scipy.optimize import minimize


def infeasibility(A, b, x, cones):
    s = b - np.einsum("bij,bj->bi", A, x)
    worst, lo = np.zeros(len(s)), 0
    for kind, dim in cones:
        v = s[:, lo:lo + dim]
        lo += dim
        worst = np.maximum(worst, np.abs(v).max(axis=1) if kind == "zero"
                           else -v.min(axis=1))
    return worst / np.maximum(1.0, np.abs(b).max(axis=1))


def solve(P, q, A, b, cones, mode="float64"):
    P, q, A, b = (t.cpu().double().numpy() for t in (P, q, A, b))
    nz = cones[0][1]
    xs, ok = [], []
    for Pi, qi, Ai, bi in zip(P, q, A, b):
        cons = [{"type": kind, "fun": lambda x, a=a, c=c: c - a @ x,
                 "jac": lambda x, a=a: -a}
                for kind, a, c in (("eq", Ai[:nz], bi[:nz]),
                                   ("ineq", Ai[nz:], bi[nz:]))]
        r = minimize(lambda x: 0.5 * x @ Pi @ x + qi @ x,
                     np.full(len(qi), 1.0 / len(qi)),
                     jac=lambda x: Pi @ x + qi, constraints=cons,
                     method="SLSQP", options={"ftol": 1e-14, "maxiter": 500})
        xs.append(r.x)
        ok.append(bool(r.success))
    x = np.array(xs)
    f = 0.5 * np.einsum("bi,bij,bj->b", x, P, x) + (q * x).sum(1)
    return torch.from_numpy(x), torch.from_numpy(f), torch.tensor(ok)
"""


def eq_root(tmp_path):
    """A root whose only new files are the family's configuration,
    generator, reference, traffic and cell file; the shared harness and
    judge are copied as they are."""
    root = tmp_path / "root"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    pb = root / "portbench"
    (pb / "generators" / "eq_qp.py").write_text(EQ_GENERATOR)
    (pb / "references" / "eq_qp.py").write_text(EQ_REFERENCE)
    n = 6
    (pb / "configs" / "eq_qp_n6.json").write_text(json.dumps(
        {"n": n, "m": n + 2, "cones": [["zero", 1], ["nn", n + 1]],
         "generator": "eq_qp", "reference": "eq_qp"}))
    base = harness.load_cell(REPO, "socp_n6.b131072")
    (pb / "traffic" / "tiny_traffic.json").write_text(json.dumps(
        dict(base.traffic, batch=32, pool=2, warmup_calls=1,
             sample_lanes=8, reference_block=64)))
    (pb / "workloads" / "tiny.json").write_text(json.dumps(
        {"limits": {"obj_gap": 1e-6, "infeas": 1e-6, "wrong_status": 0,
                    "ref_unsolved": 0}}))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    bench["configs"].append({"name": "eq_qp_n6", "source": "bench.py qp_eq",
                             "file": "portbench/configs/eq_qp_n6.json",
                             "reduced": [], "why": "zero and nn cones"})
    bench["workloads"].append({"name": "tiny", "config": "eq_qp_n6",
                               "traffic": "tiny_traffic", "chips": 1,
                               "why": "a family of another cone kind"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("fault", [None, "altered"])
def test_config_of_another_cone_kind_lands_as_files(tmp_path, fault):
    root = eq_root(tmp_path)
    for name in ("harness.py", "judge.py", "trace.py", "kernels.py"):
        assert (root / "portbench" / name).read_bytes() == open(
            os.path.join(PB, name), "rb").read()
    result, _, err = run_tiny(root, fault=fault)
    checks = result["checks"]
    assert checks["lanes_judged"]["value"] > 0, err[-2000:]
    if fault is None:
        assert result["correct"], err[-2000:]
    else:
        # x scaled by 1 + 1e-3 leaves sum x = 1, a zero-cone row
        assert result["correct"] is False
        assert checks["infeas"]["value"] > 1e-4


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload",
         "socp_n6.b131072", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_needs_the_program(tmp_path):
    """With only BENCHMARK.json and portbench/, a run cannot start."""
    shutil.copytree(PB, tmp_path / "portbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    code = ("import sys\n"
            f"sys.path = [{str(tmp_path)!r}] + [p for p in sys.path if p "
            f"and not p.startswith({REPO!r})]\n"
            "from portbench import harness\n"
            "sys.exit(harness.main(['--workload', 'socp_n6.b131072', "
            "'--seed', '1', '--seconds', '1'], "
            f"root={str(tmp_path)!r}, device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_nothing_of_the_port():
    files = [f for f in glob.glob(os.path.join(PB, "**", "*.py"),
                                  recursive=True)
             if os.sep + "tests" + os.sep not in f]
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & set(harness.FORBIDDEN), f
        src = open(f).read()
        assert "benchmarks/" not in src and "benchmarks." not in src, f
        if os.path.basename(f) not in ("harness.py",):
            assert "clarabel_tpu_torch" not in names, f


class _Event:
    def __init__(self, name, act, start, end, cpu=False):
        self._v = (name, act, start, end, cpu)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[4]
                else torch.autograd.DeviceType.CUDA)


class _OldEvent(_Event):
    """An event of a profiler that gives no activity type."""
    activity_type = property()


@pytest.mark.parametrize("cls", [_Event, _OldEvent])
def test_trace_reduction(cls):
    ev = [
        cls(trace.CALL_SPAN, "user_annotation", 1000, 2000, True),
        cls("aten::index", "cpu_op", 1100, 1300, True),
        cls(trace.CALL_SPAN, "user_annotation", 2100, 3000, True),
        cls("mk_kernel(...)", "kernel", 1200, 1600),
        # a copy overlapping the kernel: busy once
        cls("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1500, 1700),
        cls("ldl_rows_wide_kernel", "kernel", 2200, 2500),
        cls("elementwise_kernel", "kernel", 2900, 3000),
        cls(trace.CALL_SPAN, "user_annotation", 3200, 3300, True),
        cls("elementwise_kernel", "kernel", 3200, 3300),
        # outside the window: clipped away
        cls("mk_kernel(...)", "kernel", 100, 900),
        # not device work
        cls(trace.CALL_SPAN, "gpu_user_annotation", 1000, 2000),
        cls("Stream Sync", "cuda_sync", 1000, 2000),
    ]
    rec = trace.reduce_events(ev)
    assert rec.calls == 3
    assert rec.window_s == pytest.approx(2300e-9)
    assert rec.busy_s == pytest.approx((500 + 300 + 100 + 100) * 1e-9)
    assert rec.kernels["mk_kernel(...)"] == [1, pytest.approx(400e-9)]
    assert rec.copy_seconds() == pytest.approx(200e-9)
    idle = dict(rec.idle_by_host)
    assert idle == {
        "aten::index": pytest.approx(200e-9),               # 1000-1200
        f"{trace.CALL_SPAN}: host work outside torch ops":
            pytest.approx(900e-9),              # 1700-2200, 2500-2900
        "between calls: the harness": pytest.approx(200e-9)}  # 3000-3200
    assert rec.skipped == {trace.CALL_SPAN: 1, "Stream Sync": 1}


def _run_with(device, iterations=100, lanes=10, calls=2):
    # the loop's readers (K2, the loop's ops) over a batch of 65,536 lanes
    cell = harness.load_cell(REPO, "socp_n6.b131072")
    cell.traffic.update(batch=65536)
    return harness.Run(cell=cell, setup_s=1.0, window_s=2.0,
                       walls=[1.0] * calls, lanes=lanes, solved=lanes,
                       iterations=iterations, device=device)


def test_readers():
    rec = trace.DeviceRecord(
        window_s=2.0, busy_s=1.5,
        kernels={"mk_kernel(In, ...)": [4, 0.2],
                 "ldl_rows_wide_kernel": [30, 0.05],
                 "void at::native::elementwise_kernel<...>": [900, 0.8]},
        copies={"Memcpy DtoH (Device -> Pageable)": [2, 0.1]},
        idle_by_host=[], calls=2)
    run = _run_with(rec)
    read = {name: harness.load_part(REPO, "metrics", name).read(run)
            for name in ("device_idle_pct", "mk_ms_per_call",
                         "k2_ms_per_call", "copy_ms_per_call",
                         "loop_ops_ms_per_call", "ipm_iters_mean",
                         "solves_per_s", "setup_s")}
    assert read["device_idle_pct"] == pytest.approx(25.0)
    assert read["mk_ms_per_call"] == pytest.approx(100.0)
    assert read["k2_ms_per_call"] == pytest.approx(25.0)
    assert read["copy_ms_per_call"] == pytest.approx(50.0)
    assert read["loop_ops_ms_per_call"] == pytest.approx(400.0)
    assert read["ipm_iters_mean"] == pytest.approx(10.0)
    assert read["solves_per_s"] == pytest.approx(5.0)
    from portbench import arith
    # K2's work is its 30 launches over the whole batch, at N = 6 + 13
    given = 30 * run.cell.traffic["batch"]
    k2 = harness.load_part(REPO, "metrics", "k2_roofline_pct").read(run)
    assert k2 == pytest.approx(
        100 * arith.k2_bound_ms(19, given)[0] * 1e-3 / 0.05)
    need = harness.load_part(REPO, "metrics", "k2_lanes_need_pct").read(run)
    assert need == pytest.approx(100 * (100 + 10) / given)
    # no device record (a CPU run): the device readers find nothing
    bare = _run_with(None)
    for name in ("device_idle_pct", "mk_roofline_pct", "k2_roofline_pct",
                 "k2_lanes_need_pct", "loop_ops_ms_per_call",
                 "copy_ms_per_call"):
        assert harness.load_part(REPO, "metrics", name).read(bare) is None
    # no K1 launch in the window: the K1 readers find nothing, not 0
    quiet = _run_with(trace.DeviceRecord(2.0, 1.0, {"x": [1, 1.0]}, {}, [],
                                         2))
    for name in ("mk_roofline_pct", "mk_ms_per_call", "k2_roofline_pct",
                 "k2_lanes_need_pct"):
        assert harness.load_part(REPO, "metrics", name).read(quiet) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["socp_n6.b131072"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload", cell,
         "--seed", "5000000011", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-3000:]
    assert result["device"]["platform"] == "gpu"
