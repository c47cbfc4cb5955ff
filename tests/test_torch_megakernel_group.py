"""Which CUDA source a megakernel shape builds from (`ipm/_cuda.py`).

Single-phase zero/nn/SOC layouts (K1a) launch the group kernel of
`csrc/megakernel_group.cu`, one lane per group of threads, up to
`GROUP_LANES_PER_SM` lanes an SM, and `csrc/megakernel.cu` above;
single-phase exp/pow layouts (K1b) the group kernel up to
`NONSYM_GROUP_LANES_PER_SM` lanes an SM (at every B where it is None) and
`csrc/megakernel.cu` above; every other layout (K1c-K1e) always
`csrc/megakernel.cu`, at every batch size and chunk.  The source is part
of the build key: the library's name carries the source's name and a hash
of its text, so an edit of one source rebuilds only its libraries.  The
two sources share MkParams field for field where the group kernel
applies.  No card is needed.
"""

import os
import re
import shutil

import pytest

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch.ipm import _cuda

GROUP, LOOP = "megakernel_group.cu", "megakernel.cu"


def _shape(cones, n, two=False, **change):
    st = ctt.Settings(kkt_backend="megakernel", megakernel_two_phase=two,
                      **change)
    return _cuda.shape_of(ctt.BatchSolver(cones, n, st,
                                          device="cpu")._mega_fn.spec)


EXP = [ctt.NonnegativeConeT(2), ctt.ExponentialConeT()]
GENPOW = [ctt.NonnegativeConeT(2), ctt.GenPowerConeT((0.3, 0.7), 2)]


CASES = [
    ("nn_soc", [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)], 6,
     False, GROUP),
    ("nn_soc two-phase", [ctt.NonnegativeConeT(6), ctt.SecondOrderConeT(7)],
     6, True, LOOP),
    ("zero_nn", [ctt.ZeroConeT(1), ctt.NonnegativeConeT(7)], 6, False, GROUP),
    ("socs m=22", [ctt.NonnegativeConeT(10), ctt.SecondOrderConeT(3),
                   ctt.SecondOrderConeT(4), ctt.SecondOrderConeT(5)], 5,
     False, GROUP),
    ("exp", EXP, 3, False, GROUP),
    ("pow", [ctt.NonnegativeConeT(2), ctt.PowerConeT(0.6)], 3, False, GROUP),
    ("exp and soc", [ctt.SecondOrderConeT(3), ctt.ExponentialConeT(),
                     ctt.PowerConeT(0.3)], 4, False, GROUP),
    ("genpow", GENPOW, 4, False, LOOP),
    ("genpow two-phase", GENPOW, 4, True, LOOP),
    ("psd", [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3, False,
     LOOP),
    ("psd two-phase", [ctt.NonnegativeConeT(6), ctt.PSDTriangleConeT(3)], 3,
     True, LOOP),
    ("psd2 with a zero cone", [ctt.ZeroConeT(1), ctt.NonnegativeConeT(5),
                               ctt.PSDTriangleConeT(2)], 3, False, LOOP),
    ("psd and exp", [ctt.PSDTriangleConeT(2), ctt.ExponentialConeT()], 3,
     False, LOOP),
]


# the switch batch of chip_smoke.py [8]: the exp layout with its setting
CASES.append(("switch", EXP, 3, False, GROUP))
SWITCH = {"switch": dict(min_switch_step_length=0.9)}


@pytest.mark.parametrize("name,cones,n,two,source", CASES,
                         ids=[c[0] for c in CASES])
def test_variants_by_cone_family_and_batch(name, cones, n, two, source):
    """An eligible shape launches the group kernel up to its cap of lanes
    an SM (GROUP_LANES_PER_SM for K1a, NONSYM_GROUP_LANES_PER_SM for K1b,
    every B where that is None) and the one-lane-per-thread kernel above;
    the others (genpow, PSD and two-phase layouts; `group_eligible` says
    why) always the latter.  Each variant names its source; on the card's 132
    SMs the launches at chip_smoke.py's batch sizes and at the main path's
    chunk of 16384 lanes take the source the cap gives."""
    shape = _shape(cones, n, two, **SWITCH.get(name, {}))
    assert _cuda.group_eligible(shape) == (source == GROUP)
    sms = 132
    cap = _cuda.group_cap(shape)
    assert cap == (_cuda.NONSYM_GROUP_LANES_PER_SM if shape[3]
                   else _cuda.GROUP_LANES_PER_SM)
    if source == GROUP and cap is None:
        for B in (1, 4096, 65536, 131072, 10 ** 7):
            assert _cuda.source_for(_cuda.variant_of(shape, B, sms)) == GROUP
        assert _cuda.variants_of(shape) == [shape + (1,)]
    else:
        edge = (cap if cap is not None else 54) * sms
        small, big = _cuda.variant_of(shape, edge, sms), \
            _cuda.variant_of(shape, edge + 1, sms)
        assert _cuda.source_for(small) == source
        assert _cuda.source_for(big) == LOOP
        assert _cuda.variants_of(shape) == sorted({small, big})
    for B in (4096, 16384, 65536, 131072):
        grp = source == GROUP and (cap is None or B <= cap * sms)
        assert _cuda.source_for(_cuda.variant_of(shape, B, sms)) == (
            GROUP if grp else LOOP)
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
    genpow, PSD or two-phase libraries compile (an exp/pow library
    compiles every other field)."""
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
    """The fields of K1a and K1b libraries, the exp/pow ones among them
    (the pow exponents, the switch and the line searches' settings), are
    declared alike in both sources; the group source refuses the layouts
    it does not take."""
    csrc = os.path.dirname(_cuda.megakernel.source)
    fields = _params_fields(os.path.join(csrc, GROUP))
    assert fields == _params_fields(os.path.join(csrc, LOOP))
    assert any("seg_kind" in f for f in fields)
    for name in ("seg_alpha", "min_switch_step_length",
                 "linesearch_backtrack_step", "linesearch_max_iter"):
        assert any(name in f for f in fields), name
    text = open(os.path.join(csrc, GROUP)).read()
    # single-phase layouts without genpow or PSD segments only
    assert '#error "the float32 first phase' in text
    assert "#if MK_PSD || MK_GENPOW\n#error" in text
    assert "#if MK_NONSYM || " not in text
