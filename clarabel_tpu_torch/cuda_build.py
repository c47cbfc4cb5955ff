"""Build the CUDA sources of this package into shared libraries and load them.

Every kernel of the port has a plain C interface and is bound with ctypes:
nvcc by hand builds such a source in seconds, where one that includes
PyTorch's headers takes minutes.  A `CudaLibrary` is one source under
`csrc/`.  It is compiled with nvcc for sm_90a at first use, once per
variant (a tuple of compile-time `-D` values; the empty tuple for a source
that takes none), into `build/kernels/` beside the package (a directory
that `.gitignore` lists).  The library name carries the source's name and
a hash of the source and the flags, so an edited source builds anew; a
subclass may build its variants from more than one source (`source_for`).

`build_together` starts one nvcc for every missing library of every source
it is given, all at once, and waits for them; a failed build raises.  Each
library's log and seconds from start to end are kept (`build_logs`,
`build_seconds`).
Nothing here falls back to anything: a kernel that does not build is an
error.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Variant = Tuple[int, ...]

_BUILD_LOCK = threading.Lock()


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class CudaLibrary:
    """One CUDA source and the libraries built from it, one per variant.

    `macros` name the `-D` values of a variant and `tags` the short names
    that go into the library's file name (`megakernel_n6_m13_s2_<hash>.so`).
    A subclass binds the library's functions in `bind(lib, variant)`."""

    def __init__(self, source_name: str, macros: Sequence[str] = (),
                 tags: Sequence[str] = ()):
        self.source = os.path.join(CSRC, source_name)
        self.stem = os.path.splitext(source_name)[0]
        self.macros = tuple(macros)
        self.tags = tuple(tags)
        self.build_logs: Dict[Variant, str] = {}
        self.build_seconds: Dict[Variant, float] = {}
        self._libs: Dict[Variant, ctypes.CDLL] = {}

    def source_for(self, variant: Variant = ()) -> str:
        """The source a variant builds from (one per library by default)."""
        return self.source

    def flags_for(self, variant: Variant = ()) -> Tuple[str, ...]:
        """nvcc flags a variant adds to NVCC_FLAGS (none by default)."""
        return ()

    def lib_path(self, variant: Variant = ()) -> str:
        source = self.source_for(variant)
        with open(source, "rb") as f:
            h = hashlib.sha1(f.read())
        h.update(" ".join(NVCC_FLAGS + self.flags_for(variant)).encode())
        stem = (self.stem if source == self.source
                else os.path.splitext(os.path.basename(source))[0])
        tag = "".join(f"_{t}{v}" for t, v in zip(self.tags, variant))
        return os.path.join(BUILD_DIR, f"{stem}{tag}_{h.hexdigest()[:12]}.so")

    def _start(self, variants: Iterable[Variant]):
        """Start nvcc for each variant not built yet; returns the running
        builds."""
        procs = []
        for variant in dict.fromkeys(tuple(v) for v in variants):
            out = self.lib_path(variant)
            if variant in self._libs or os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            defines = [f"-D{mac}={val}"
                       for mac, val in zip(self.macros, variant)]
            cmd = [nvcc_path(), *NVCC_FLAGS, *self.flags_for(variant),
                   *defines, "-o", tmp, self.source_for(variant)]
            procs.append((variant, out, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        return procs

    def _finish(self, build, log: str, seconds: float) -> List[str]:
        """Keep one ended build's log and seconds; returns its failure."""
        variant, out, tmp, _, proc = build
        self.build_logs[variant] = log
        self.build_seconds[variant] = seconds
        if proc.returncode != 0:
            return [f"{self.stem} {variant}:\n{log}"]
        os.replace(tmp, out)
        return []

    def build(self, variants: Iterable[Variant] = ((),)) -> None:
        build_together((self, variants))

    def bind(self, lib: ctypes.CDLL, variant: Variant) -> None:
        raise NotImplementedError

    def load(self, variant: Variant = ()) -> ctypes.CDLL:
        """The library for `variant`, built first if it is missing."""
        variant = tuple(variant)
        lib = self._libs.get(variant)
        if lib is None:
            self.build([variant])
            lib = ctypes.CDLL(self.lib_path(variant))
            self.bind(lib, variant)
            self._libs[variant] = lib
        return lib


def build_together(*requests: Tuple[CudaLibrary, Iterable[Variant]]) -> None:
    """Build every missing (library, variant) of `requests` with one nvcc
    each, all started together; raises if any build fails."""
    with _BUILD_LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        started = [(lib, build) for lib, variants in requests
                   for build in lib._start(variants)]

        def wait(item):
            build = item[1]
            log, _ = build[4].communicate()
            return log, time.perf_counter() - build[3]

        # one waiter for each build, so that each one's end is its own
        with ThreadPoolExecutor(max_workers=max(1, len(started))) as pool:
            ended = list(pool.map(wait, started))
        failed = []
        for (lib, build), (log, seconds) in zip(started, ended):
            failed += lib._finish(build, log, seconds)
    if failed:
        raise RuntimeError("nvcc failed for " + "; ".join(failed))
