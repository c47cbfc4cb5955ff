"""How `correct` is decided: the program's answers against the reference.

Every problem of the pool is feasible and bounded (x = 0 lies inside the
cones and P is positive definite), so a lane answers in one of two ways:

* SOLVED, with an x.  For a sample of the window's lanes, drawn from the
  seed lane by lane in every call, the reference (`portbench/references/`,
  named by the configuration) solves the same problem again from the
  generated inputs, far beyond the program's tolerance, and the x the
  program returned is judged by
  - `obj_gap`: |f(x) - f*| / max(1, |f*|), f = 1/2 x'Px + q'x, f* the
    reference's optimum;
  - `infeas`: how far s = b - A x lies outside the cones over
    max(1, |b|_inf), as the configuration's reference measures it
    (`infeasibility(A, b, x, cones)` of its module, which knows the
    family's cones);
  each the worst over the judged lanes.
* Anything else.  A lane that ends unsolved (MAX_ITERATIONS, ALMOST_SOLVED,
  ...) is a failed operation, counted apart and not here; a lane that
  certifies infeasibility says the wrong thing: `wrong_status`, over every
  lane of every call, has the limit 0.

`ref_unsolved` counts judged lanes on which the reference did not reach
its own tolerance; it has the limit 0, since such a lane cannot be judged.
The limits of `obj_gap` and `infeas` sit in the cell's file under
`portbench/workloads/`, with the readings they were set from (PERF.md).
"""

import dataclasses
from typing import Dict, List

import numpy as np
import torch

INFEASIBLE = ("PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE",
              "ALMOST_PRIMAL_INFEASIBLE", "ALMOST_DUAL_INFEASIBLE")
CHECKS = ("obj_gap", "infeas", "wrong_status", "ref_unsolved")


@dataclasses.dataclass
class Sample:
    """What one call returned on its sampled lanes."""
    batch: int              # which problem batch of the pool
    lanes: np.ndarray       # (S,) lane indices
    x: np.ndarray           # (S, n) the program's x
    solved: np.ndarray      # (S,) the program said SOLVED


def objective(P, q, x):
    return 0.5 * np.einsum("bi,bij,bj->b", x, P, x) + np.einsum(
        "bi,bi->b", q, x)


def wanted_lanes(samples: List[Sample]) -> Dict[int, np.ndarray]:
    """Per pool batch, the sorted lanes that some call has to be judged
    on (those the program said SOLVED)."""
    got: Dict[int, list] = {}
    for smp in samples:
        if smp.solved.any():
            got.setdefault(smp.batch, []).append(smp.lanes[smp.solved])
    return {k: np.unique(np.concatenate(v)) for k, v in got.items()}


def reference_solve(solve, pool, lanes_by_batch, cones, device, mode,
                    block):
    """Run `solve` (the configuration's reference) on the given lanes of
    each pool batch, `block` lanes at a time on `device`.  Returns
    {batch: (lanes, x, f, ok)} as numpy."""
    out = {}
    for k, lanes in lanes_by_batch.items():
        xs, fs, oks = [], [], []
        for lo in range(0, len(lanes), block):
            sel = lanes[lo:lo + block]
            args = [torch.from_numpy(np.ascontiguousarray(a[sel])).to(device)
                    for a in pool[k]]
            x, f, ok = solve(*args, cones, mode=mode)
            xs.append(x.cpu().numpy())
            fs.append(f.cpu().numpy())
            oks.append(ok.cpu().numpy())
        out[k] = (lanes, np.concatenate(xs), np.concatenate(fs),
                  np.concatenate(oks))
    return out


def readings(pool, samples: List[Sample], optima, ref, cones,
             wrong_status: int) -> Dict[str, float]:
    """The compared numbers, worst over every judged lane of every call;
    `ref` is the configuration's reference module."""
    worst = dict(obj_gap=0.0, infeas=0.0)
    unsolved_ref, judged = 0, 0
    for smp in samples:
        if not smp.solved.any():
            continue
        lanes, x = smp.lanes[smp.solved], smp.x[smp.solved]
        ref_lanes, _, f_ref, ok = optima[smp.batch]
        pos = np.searchsorted(ref_lanes, lanes)
        P, q, A, b = (a[lanes] for a in pool[smp.batch])
        gap = np.abs(objective(P, q, x) - f_ref[pos]) / np.maximum(
            1.0, np.abs(f_ref[pos]))
        inf = ref.infeasibility(A, b, x, cones)
        bad = ~np.isfinite(gap) | ~np.isfinite(inf)
        gap[bad], inf[bad] = np.inf, np.inf
        worst["obj_gap"] = max(worst["obj_gap"], float(gap.max()))
        worst["infeas"] = max(worst["infeas"], float(inf.max()))
        unsolved_ref += int((~ok[pos]).sum())
        judged += len(lanes)
    return dict(worst, wrong_status=wrong_status, ref_unsolved=unsolved_ref,
                judged_lanes=judged)


def verdict(read: Dict[str, float], limits: Dict[str, float]):
    """(correct, {check: {"value", "limit"}}): every check at or under its
    limit, and at least one lane judged (`lanes_judged`, whose "least" is
    a floor): a window with nothing judged shows nothing."""
    checks = {c: {"value": read[c], "limit": limits[c]} for c in CHECKS}
    ok = read["judged_lanes"] > 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    checks["lanes_judged"] = {"value": read["judged_lanes"], "least": 1}
    return bool(ok), checks
