"""The loop solver's inner loops over a batch, with few host syncs.

The reference runs the one-sided Newton iteration, the feasibility and
barrier backtracks and iterative refinement as `lax.while_loop`s, which
stay on the device.  Their batched ports update only through per-lane
masks (`torch.where`): a trip taken after a lane is done leaves that lane
as it was.  So a loop need not ask the host after every trip whether a lane
still runs.  `run_trips` asks before its first trip and then once every
`TRIPS_PER_CHECK` trips, and never while a CUDA graph is being captured
(`ipm/loop.py` captures the IPM iteration on the card), where it runs the
loop to its cap.  Every lane gets the bits the loop that asks after each
trip gives it.

TRIPS_PER_CHECK is chosen on the card (H100, PERF.md section 5: `tools/
megakernel_probe.py loops`, with the trip counts of `tools/search_trips.py
loops`): on the eager paths a check after every trip was as fast as a check
every 2 trips or faster (genpow: 1,612 against 1,879 ms at 4096 lanes),
and every 4 trips was slower on every path.  An eager host check costs
little, because the card waits for launches anyway, while every extra
masked trip costs its launches.  The syncs go where the IPM pass runs as a
CUDA graph: there no inner loop asks the host at all.
"""

import torch

TRIPS_PER_CHECK = 1


def run_trips(trip, state, finished, cap):
    """state = trip(state) until finished(state) (a 0-dim bool tensor)
    holds or `cap` trips have run (None: no cap).  finished is read on the
    host before the first trip and after every TRIPS_PER_CHECK trips; while
    the current CUDA stream is capturing a graph it is not read and `cap`
    trips run."""
    flag = finished(state)
    if flag.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        if cap is None:
            raise RuntimeError("a loop without a trip cap cannot run inside "
                               "a CUDA graph")
        for _ in range(cap):
            state = trip(state)
        return state
    taken = 0
    while (cap is None or taken < cap) and not bool(flag):
        chunk = TRIPS_PER_CHECK if cap is None else min(TRIPS_PER_CHECK,
                                                        cap - taken)
        for _ in range(chunk):
            state = trip(state)
        taken += chunk
        flag = finished(state)
    return state
