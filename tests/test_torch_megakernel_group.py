"""Which CUDA source a megakernel shape builds from (`ipm/_cuda.py`).

Single-phase zero/nn/SOC layouts (K1a) launch the group kernel of
`csrc/megakernel_group.cu`, one lane per group of threads, up to
`GROUP_LANES_PER_SM` lanes an SM, and `csrc/megakernel.cu` above; every
other layout (K1b-K1e) always `csrc/megakernel.cu`.  The source is part of the build key: the library's
name carries the source's name and a hash of its text, so an edit of one
source rebuilds only its libraries.  The two sources share MkParams field
for field where the group kernel applies.  No card is needed.
"""

import os
import re
import shutil

import pytest

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.ipm import _cuda

GROUP, LOOP = "megakernel_group.cu", "megakernel.cu"


def _shape(cones, n, two=False):
    st = ctt.Settings(kkt_backend="megakernel", megakernel_two_phase=two)
    return _cuda.shape_of(ctt.BatchSolver(cones, n, st,
                                          device="cpu")._mega_fn.spec)


CASES = [
    ("nn_soc", [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)], 6,
     False, GROUP),
    ("nn_soc two-phase", [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)],
     6, True, LOOP),
    ("zero_nn", [ctt.ZeroConeT(1), ctt.NonnegativeConeT(7)], 6, False, GROUP),
    ("socs m=22", [ctt.NonnegativeConeT(10), ctt.SecondOrderConeT(3),
                   ctt.SecondOrderConeT(4), ctt.SecondOrderConeT(5)], 5,
     False, GROUP),
    ("exp", [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()], 3, False,
     LOOP),
    ("pow", [ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)], 3, False, LOOP),
    ("genpow", [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)],
     4, False, LOOP),
    ("psd", [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3, False,
     LOOP),
    ("psd two-phase", [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3,
     True, LOOP),
]


@pytest.mark.parametrize("name,cones,n,two,source", CASES,
                         ids=[c[0] for c in CASES])
def test_variants_by_cone_family_and_batch(name, cones, n, two, source):
    """An eligible shape launches the group kernel up to
    GROUP_LANES_PER_SM lanes an SM and the one-lane-per-thread kernel
    above; the others always the latter.  Each variant names its source."""
    shape = _shape(cones, n, two)
    assert _cuda.group_eligible(shape) == (source == GROUP)
    sms = 132
    cap = _cuda.GROUP_LANES_PER_SM * sms
    small, big = _cuda.variant_of(shape, cap, sms), \
        _cuda.variant_of(shape, cap + 1, sms)
    assert _cuda.source_for(small) == source
    assert _cuda.source_for(big) == LOOP
    assert _cuda.variants_of(shape) == sorted({small, big})
    for v in _cuda.variants_of(shape):
        path = _cuda.megakernel.source_for(v)
        assert os.path.basename(path) == _cuda.source_for(v)
        lib = os.path.basename(_cuda.megakernel.lib_path(v))
        assert lib.startswith(os.path.splitext(_cuda.source_for(v))[0] + "_n")
        assert lib.split("_tp")[1].startswith(f"{shape[6]}_grp{v[7]}_")


def test_the_source_is_part_of_the_build_key(tmp_path, monkeypatch):
    """Editing the group source renames the group libraries only."""
    csrc = os.path.dirname(_cuda.megakernel.source)
    for f in (GROUP, LOOP):
        shutil.copy(os.path.join(csrc, f), tmp_path / f)
    kern = _cuda.Megakernel()
    monkeypatch.setattr(kern, "source", str(tmp_path / LOOP))
    shape = _shape([ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)], 6)
    group, thread = shape + (1,), shape + (0,)
    exp = _shape([ctt.NonnegativeConeT(2), ctt.ExponentialConeT()], 3) + (0,)
    before = [kern.lib_path(v) for v in (group, thread, exp)]
    with open(tmp_path / GROUP, "a") as f:
        f.write("\n// edited\n")
    after = [kern.lib_path(v) for v in (group, thread, exp)]
    assert after[0] != before[0] and after[1:] == before[1:]
    assert os.path.basename(after[0]).startswith("megakernel_group_")
    assert os.path.basename(after[2]).startswith("megakernel_n3")


def _params_fields(path):
    """MkParams' declarations of a source, without the blocks that only
    exp/pow, genpow, PSD or two-phase libraries compile."""
    text = open(path).read()
    body = re.search(r"struct MkParams \{(.*?)\n\};", text, re.S).group(1)
    out, stack = [], []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line.startswith("#if"):
            stack.append(any(f in line for f in ("MK_GENPOW", "MK_PSD",
                                                 "MK_TWO_PHASE")))
        elif line.startswith("#endif"):
            stack.pop()
        elif line and not any(stack):
            out.append(re.sub(r"\s+", " ", line))
    return out


def test_the_sources_share_mkparams():
    csrc = os.path.dirname(_cuda.megakernel.source)
    fields = _params_fields(os.path.join(csrc, GROUP))
    assert fields == _params_fields(os.path.join(csrc, LOOP))
    assert any("seg_kind" in f for f in fields)
    # the group source takes single-phase layouts only
    assert '#error "the float32 first phase' in open(
        os.path.join(csrc, GROUP)).read()
