"""What the port's batched loop solver reads against the committed JAX loop
fixtures (`loop_bench.npz`, `loop_socs.npz`), setting by setting: SOLVED
counts, the lanes whose status differs, and on the lanes both solve the
largest |dobj|, |dx| and iteration difference.  The port runs on the CPU
(the float32 settings on the K2 route, as tests/test_torch_loop.py runs
them); no JAX is needed.  Run from the repository root:

    python tests/torch_fixtures/loop_readings.py
"""

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import clarabel_tpu_torch as ctt
    from clarabel_tpu_torch.cones.layout import ConeLayout
    from clarabel_tpu_torch.ipm import loop

    spec = importlib.util.spec_from_file_location(
        "make_loop_fixtures", os.path.join(HERE, "make_loop_fixtures.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for case, names in script.CASE_SETTINGS.items():
        f = np.load(os.path.join(HERE, f"loop_{case}.npz"))
        cones = [getattr(ctt, c)(d)
                 for c, d in json.loads(str(f["cones"]))]
        n = int(f["n"])
        data = [torch.from_numpy(f[k]) for k in "PqAb"]
        for name in names:
            extra = ({"use_pallas": True}
                     if name in ("throughput", "mixed") else {})
            st = script.make_settings(ctt, name, **extra)
            out = loop.build_solve(ConeLayout(cones), st, n, True)(*data)
            out = {k: v.numpy() for k, v in out.items()}
            ref = {k: f[f"ref_{name}_{k}"] for k in script.OUT_KEYS}
            diff = np.nonzero(out["status"] != ref["status"])[0]
            both = (out["status"] == 1) & (ref["status"] == 1)
            dobj = np.abs(out["obj_val"] - ref["obj_val"])[both]
            rel = dobj / np.maximum(1.0, np.abs(ref["obj_val"][both]))
            dx = np.abs(out["x"] - ref["x"])[both]
            dit = np.abs(out["iterations"].astype(int)
                         - ref["iterations"])[both]
            print(f"{case}/{name}: SOLVED port {(out['status'] == 1).sum()} "
                  f"reference {(ref['status'] == 1).sum()} of "
                  f"{len(both)}; statuses differ on lanes {diff.tolist()} "
                  f"(port {out['status'][diff].tolist()}, reference "
                  f"{ref['status'][diff].tolist()}); on the {both.sum()} "
                  f"lanes both solve: max|dobj| {dobj.max():.2e} (relative "
                  f"{rel.max():.2e}), max|dx| {dx.max():.2e}, max iteration "
                  f"difference {dit.max()}")


if __name__ == "__main__":
    main()
