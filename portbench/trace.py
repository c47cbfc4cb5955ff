"""The traced run: `torch.profiler` over the window, reduced in memory.

No trace file is written: a window of the loop cells holds hundreds of
thousands of launches.  `Tracer.stop` turns the profiler's raw events into
a `DeviceRecord`, from which the per-layer readers (`portbench/metrics/`)
take what they need:

* the window: from the start of the first span the harness opened around
  a `BatchSolver.solve` call (`CALL_SPAN`) to the end of the last, on the
  profiler's clock;
* the device's work in it: every kernel, memcpy and memset, clipped to the
  window, with the union of their intervals (so that a copy overlapping a
  kernel on another stream is busy time once);
* per name, the count and the seconds of device work;
* the idle gaps of the union, the longest `LABELLED_GAPS` each named by
  the innermost host event (operator, runtime call or span) that was open
  at the gap's midpoint, summed by name.
"""

import collections
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

CALL_SPAN = "portbench.call"
COPY_ACTIVITIES = ("gpu_memcpy", "gpu_memset")
# the longest gaps are named one by one; the rest are summed together
LABELLED_GAPS = 5000


@dataclasses.dataclass
class DeviceRecord:
    window_s: float
    busy_s: float
    # name -> [launches, seconds]: kernels, and copies and sets apart
    kernels: Dict[str, List[float]]
    copies: Dict[str, List[float]]
    # (what the host was doing, seconds) summed over the idle gaps
    idle_by_host: List[Tuple[str, float]]
    calls: int
    # device-side events that are not device work (synchronisations, the
    # shadows of host spans): name -> count, for the run's log
    skipped: Dict[str, int] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose name `match(name)` accepts."""
        return sum(s for name, (_, s) in self.kernels.items() if match(name))

    def kernel_launches(self, match) -> int:
        """Launches of the kernels whose name `match(name)` accepts."""
        return int(sum(c for name, (c, _) in self.kernels.items()
                       if match(name)))

    def copy_seconds(self) -> float:
        return sum(s for _, s in self.copies.values())

    def top_device_ops(self, k=10):
        ops = [(n, s) for n, (_, s) in self.kernels.items()]
        ops += [(n, s) for n, (_, s) in self.copies.items()]
        return [[n, s] for n, s in sorted(ops, key=lambda o: -o[1])[:k]]


class Tracer:
    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self):
        self._prof.start()

    def stop(self) -> DeviceRecord:
        self._prof.stop()
        return reduce_events(self._prof.profiler.kineto_results.events())


def _union(starts, ends):
    """Merged intervals of [starts, ends) sorted by start."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def _device_kind(e):
    """"kernel", "copy" or None (not device work) for one raw event.
    Older profilers give no activity type: there a device event is a copy
    or a set by its name, and a kernel unless it is a synchronisation or
    the device-side shadow of a host span."""
    if hasattr(e, "activity_type"):
        act = e.activity_type()
        if act in COPY_ACTIVITIES:
            return "copy"
        return "kernel" if act == "kernel" else None
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return None
    name = e.name()
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    if name == CALL_SPAN or name.endswith(" Sync") or "Wait Event" in name:
        return None
    return "kernel"


def _interval(e):
    start = e.start_ns()
    return start, start + e.duration_ns()


def reduce_events(events) -> DeviceRecord:
    spans, dev, host = [], [], []
    skipped = collections.Counter()
    for e in events:
        kind = _device_kind(e)
        if kind is not None:
            dev.append(_interval(e) + (e.name(), kind))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() == CALL_SPAN:
                spans.append(_interval(e))
            host.append(_interval(e) + (e.name(),))
        else:
            skipped[e.name()] += 1
    if not spans:
        raise RuntimeError(f"the trace holds no {CALL_SPAN!r} span")
    w0 = min(s for s, _ in spans)
    w1 = max(e for _, e in spans)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    copies = collections.defaultdict(lambda: [0, 0.0])
    starts, ends = [], []
    for s, e, name, kind in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        table = copies if kind == "copy" else kernels
        table[name][0] += 1
        table[name][1] += (e - s) * 1e-9
        starts.append(s)
        ends.append(e)
    busy_ns = 0
    idle = collections.Counter()
    if starts:
        us, ue = _union(np.array(starts, dtype=np.int64),
                        np.array(ends, dtype=np.int64))
        busy_ns = int((ue - us).sum())
        gap_lo = np.concatenate([[w0], ue])
        gap_hi = np.concatenate([us, [w1]])
    else:
        gap_lo, gap_hi = np.array([w0]), np.array([w1])
    keep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
    if len(gap_lo):
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
        by_start = np.argsort(hs, kind="stable")
        hs, he = hs[by_start], he[by_start]
        names = [host[i][2] for i in by_start]
        longest = np.argsort(gap_lo - gap_hi, kind="stable")
        span_lo = np.array([a for a, _ in spans], dtype=np.int64)
        span_hi = np.array([b for _, b in spans], dtype=np.int64)
        for g in longest[:LABELLED_GAPS]:
            mid = (gap_lo[g] + gap_hi[g]) // 2
            # the innermost open event: the latest start at or before mid
            # among those still open at mid (looked for among the last few
            # hundred to start; past them, only the call spans)
            j = int(np.searchsorted(hs, mid, side="right"))
            label = None
            for i in range(j - 1, max(j - 256, 0) - 1, -1):
                if he[i] >= mid and names[i] != CALL_SPAN:
                    label = names[i]
                    break
            if label is None:
                inside = ((span_lo <= mid) & (span_hi >= mid)).any()
                label = (f"{CALL_SPAN}: host work outside torch ops"
                         if inside else "between calls: the harness")
            idle[label] += (gap_hi[g] - gap_lo[g]) * 1e-9
        rest = longest[LABELLED_GAPS:]
        if len(rest):
            idle[f"the {len(rest)} shorter gaps"] += float(
                (gap_hi[rest] - gap_lo[rest]).sum()) * 1e-9
    return DeviceRecord(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
        kernels=dict(kernels), copies=dict(copies),
        idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]),
        calls=len(spans), skipped=dict(skipped))
