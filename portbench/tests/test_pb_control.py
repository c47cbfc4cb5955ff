"""The control of `correct` at a size a test run holds: the reference one
precision below what each cell states, in the program's place, comes out
not correct under the cell's own limits; at the stated precision it comes
out correct.  On the card, at the cells' own sizes:
`python3 portbench/control.py --workload <cell> --seeds ... --calls ...`
(PERF.md gives the readings)."""

import pytest

from portbench import control, harness, judge

# the megakernel cell, and the same family at the float32 tier with the
# limits its cell was held to when the benchmark had one (PERF.md
# section 7)
CELLS = ("float64", "float32")


def _cell(precision):
    cell = harness.load_cell(harness.ROOT, "socp_n6.b131072")
    cell.traffic.update(batch=256, sample_lanes=64, reference_block=256,
                        precision=precision)
    if precision == "float32":
        cell.limits = {"obj_gap": 6e-03, "infeas": 1.5e-04,
                       "wrong_status": 0, "ref_unsolved": 0}
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = _cell(name)
    mode = control.LOWER[cell.traffic["precision"]]
    for seed in (21, 22, 23):
        read = control.control_readings(harness.ROOT, cell, seed, 4, "cpu",
                                        mode)
        assert not judge.verdict(read, cell.limits)[0], read


@pytest.mark.parametrize("name", CELLS)
def test_reference_in_place_is_correct(name):
    cell = _cell(name)
    read = control.control_readings(harness.ROOT, cell, 24, 4, "cpu",
                                    "float64")
    assert judge.verdict(read, cell.limits)[0], read
