"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, the kernel libraries (built on a checkout's first run,
loaded from build/kernels/ after), the pool and the warm-up calls."""


def read(run):
    return run.setup_s
