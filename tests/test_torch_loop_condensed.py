"""The port's batched loop solver against the JAX package's vmapped
`build_solve`, live at n=2, for the condensed backend (float64).

A file of its own because the reference's compile takes most of the time
of the test; the bars and the fixtures are in tests/test_torch_loop.py."""

from test_torch_loop import check_live


def test_matches_jax_loop_live_condensed():
    check_live("condensed")
