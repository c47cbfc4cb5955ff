"""The port's QPS and CBF readers (`clarabel_tpu_torch/io/qps.py`,
`io/cbf.py`) and its command line (`python -m clarabel_tpu_torch`), on the
CPU, against the JAX package's.

Every input of `tests/test_qps_reader.py` and `tests/test_cbf_reader.py`
(the module's texts and those written inside its tests) and the four
committed `benchmarks/data/*_style.qps` files go through both readers:
the name, P, q, A, b, the cones, the objective constant, n and m (and the
CBF objective sense) are equal exactly.  The command line on
`CVXQP1_style.qps` mirrors `tests/test_qps_reader.py:157`.
"""

import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu.io.cbf import load_cbf as ref_load_cbf
from clarabel_tpu.io.qps import load_qps as ref_load_qps
from clarabel_tpu_torch.interop import cone_to_tuple
from clarabel_tpu_torch.io.cbf import load_cbf
from clarabel_tpu_torch.io.qps import load_qps

import test_cbf_reader
import test_qps_reader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "benchmarks", "data")
QPS_FILES = ("AUG2DC_style.qps", "CVXQP1_style.qps", "CVXQP2_style.qps",
             "CVXQP3_style.qps")


def _inputs(module, prefix):
    """The module's file texts: its constants named `prefix...` and the
    texts its tests write inline (`text = \"\"\"...\"\"\"`)."""
    out = {k: v for k, v in vars(module).items()
           if k.startswith(prefix) and isinstance(v, str)}
    src = inspect.getsource(module)
    for i, body in enumerate(re.findall(r'text = """\\\n(.*?)"""', src,
                                        flags=re.S)):
        out[f"inline{i}"] = body
    return out


QPS_INPUTS = _inputs(test_qps_reader, "QPS_")
CBF_INPUTS = _inputs(test_cbf_reader, "CBF_")


def _same_problem(got, ref, keys=("name", "obj_constant", "n", "m")):
    for k in keys:
        assert getattr(got, k) == getattr(ref, k), k
    for k in ("P", "A"):
        g, r = getattr(got, k), getattr(ref, k)
        assert g.shape == r.shape and type(g) is type(r), k
        np.testing.assert_array_equal(g.toarray(), r.toarray(), err_msg=k)
    for k in ("q", "b"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert [cone_to_tuple(c) for c in got.cones] == \
        [cone_to_tuple(c) for c in ref.cones]


def test_inputs_found():
    assert len(QPS_INPUTS) == 3 and len(CBF_INPUTS) == 6


@pytest.mark.parametrize("key", sorted(QPS_INPUTS))
def test_qps_reader_matches_reference(key):
    text = QPS_INPUTS[key]
    _same_problem(load_qps(text), ref_load_qps(text))


@pytest.mark.parametrize("fname", QPS_FILES)
def test_committed_qps_files_match_reference(fname):
    path = os.path.join(DATA, fname)
    got = load_qps(path)
    _same_problem(got, ref_load_qps(path))
    assert all(type(c).__module__ == "clarabel_tpu_torch.cones.api"
               for c in got.cones)


@pytest.mark.parametrize("key", sorted(CBF_INPUTS))
def test_cbf_reader_matches_reference(key):
    text = CBF_INPUTS[key]
    got, ref = load_cbf(text), ref_load_cbf(text)
    _same_problem(got, ref, keys=("name", "obj_constant", "obj_sense", "n",
                                  "m"))


def test_cbf_psdcon_solves_on_the_port():
    prob = load_cbf(test_cbf_reader.CBF_PSDCON)
    sol = ctt.Solver(prob.P.toarray(), prob.q, prob.A.toarray(), prob.b,
                     prob.cones, device="cpu").solve()
    assert sol.status == ctt.SolverStatus.SOLVED
    assert abs(sol.x[0] - 1.0) < 1e-6


def test_cli_entry_point(capsys):
    """python -m clarabel_tpu_torch file.qps --device cpu solves and
    reports, as the reference's command line does."""
    from clarabel_tpu_torch.__main__ import main

    rc = main([os.path.join(DATA, "CVXQP1_style.qps"), "--quiet",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "status=SOLVED" in out


def test_cli_timing_and_cbf(tmp_path, capsys):
    from clarabel_tpu_torch.__main__ import main

    path = tmp_path / "psdcon.cbf"
    path.write_text(test_cbf_reader.CBF_PSDCON)
    rc = main([str(path), "--quiet", "--timing", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "status=SOLVED" in out and "IPM loop" in out


def test_cli_json(tmp_path, capsys):
    from clarabel_tpu_torch.__main__ import main

    path = str(tmp_path / "p.json")
    prob = load_qps(os.path.join(DATA, "CVXQP2_style.qps"))
    ctt.save_to_file(ctt.Solver(prob.P, prob.q, prob.A, prob.b, prob.cones,
                                device="cpu"), path)
    rc = main([path, "--quiet", "--device", "cpu", "--max-iter", "50"])
    assert rc == 0 and "status=SOLVED" in capsys.readouterr().out


def test_cli_without_a_card_exits_nonzero(capsys):
    """With no card and no --device cpu the command line stops with
    resolve_device's message; it never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command line runs on it")
    from clarabel_tpu_torch.__main__ import main

    rc = main([os.path.join(DATA, "CVXQP1_style.qps"), "--quiet"])
    captured = capsys.readouterr()
    assert rc != 0 and "device='cpu'" in captured.err
    assert "status=" not in captured.out
