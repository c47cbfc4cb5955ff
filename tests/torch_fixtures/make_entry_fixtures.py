"""Make the committed `.npz` fixture of the reference `entry()`'s outputs
that `tests/test_torch_entry.py` holds the port's `entry()` against: the
repository's `__graft_entry__.entry()` (the JAX package's vmapped loop
solver for [NN(6), SOC(7)] under `Settings()`) run on its own example
batch.

Run from the repository root (the JAX compile takes about half a minute):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_entry_fixtures.py

This script imports `clarabel_tpu`, so it lives outside the port package.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_KEYS = ("x", "z", "s", "status", "iterations", "obj_val",
            "obj_val_dual")


def reference_outputs():
    """The reference entry()'s inputs and outputs, as numpy arrays."""
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    import clarabel_tpu  # noqa: F401  (x64 and the CPU platform)
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    res = {k: np.asarray(out[k]) for k in OUT_KEYS}
    for name, a in zip(("P", "q", "A", "b"), args):
        res[name] = np.asarray(a)
    return res


def main():
    import numpy as np

    res = reference_outputs()
    print("statuses", res["status"], "iterations", res["iterations"],
          flush=True)
    np.savez(os.path.join(HERE, "entry.npz"), **res)


if __name__ == "__main__":
    main()
