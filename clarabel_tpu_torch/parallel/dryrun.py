"""Start N ranks on this host and run the multi-device dryrun on each.

    python -m clarabel_tpu_torch.parallel.dryrun --nproc N [--device cpu]
        [--backend gloo|nccl] [--timeout SECONDS]

The counterpart of `benchmarks/multihost_dryrun.py`.  Each rank is a
process started with the spawn method, joined by a `file://` rendezvous in
a temporary directory; each runs `entry.dryrun_multichip` and rank 0
prints its summary line and then `MULTIDEVICE DRYRUN PASS`.  The exit code
is non-zero when a rank fails or the run passes its time limit.  Without
`--device cpu` every rank takes the card LOCAL_RANK % device_count() (two
ranks may share one card over gloo); the backend defaults to NCCL on cards
and gloo on the CPU.

`launch` is the same start for any function: the tests and the smoke run
use it for their own ranks.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time


def _rank_main(fn, rank, world, init_method, backend, device, args):
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, nproc: int, backend: str, device=None, args=(),
           timeout: float = 600.0) -> list:
    """Run fn(rank, world, *args) in nproc spawned processes under an
    initialized default process group of `backend` (torch.set_num_threads(1)
    on the CPU, else each rank on card rank % device_count()), and join
    them.  When a rank fails the others are stopped, and so are all of them
    at `timeout` seconds.  Returns the exit codes, rank by rank (None where
    a rank was stopped at the time limit)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rendezvous_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nproc, init_method, backend, device,
                               tuple(args)))
             for r in range(nproc)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    return codes


def _dryrun_rank(rank, world, device):
    from ..entry import dryrun_multichip

    dryrun_multichip(device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run the ranks on the CPU (default: the cards)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    opts = ap.parse_args(argv)
    backend = opts.backend or ("gloo" if opts.device == "cpu" else "nccl")
    if opts.device is None:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device is available; pass --device cpu",
                  file=sys.stderr)
            return 2
    codes = launch(_dryrun_rank, opts.nproc, backend, opts.device,
                   (opts.device,), opts.timeout)
    if any(c != 0 for c in codes):
        print(f"MULTIDEVICE DRYRUN FAIL: exit codes by rank {codes} "
              f"(None: stopped at the {opts.timeout:.0f} s limit)",
              file=sys.stderr)
        return 1
    print("MULTIDEVICE DRYRUN PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
