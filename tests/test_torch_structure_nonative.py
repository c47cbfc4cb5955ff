"""The port's KKT structure analysis against the JAX package's with the
native symbolic library switched off in both packages, so that only the
Python bisectors race: the plans of `tests/test_torch_structure.py`'s
patterns agree array for array.
"""

import pytest

from test_torch_structure import PATTERNS, check_plans, set_native_mode


@pytest.mark.parametrize("name", PATTERNS)
def test_plans_equal_the_reference_without_native(name, monkeypatch):
    set_native_mode("python", monkeypatch)
    check_plans(name)
