"""Host side of the batched IPM megakernel (K1a: zero/nn/soc segments;
K1b: exponential and power segments; K1c: generalized power segments; K1d:
PSD-triangle segments of side at most 3; K1e: the opt-in float32 first
phase, `Settings.megakernel_two_phase`).

The reference (`clarabel_tpu/ipm/megakernel.py`) runs the whole batched
IPM as one Pallas kernel per 1024-lane block.  The port runs it as one
CUDA kernel per dispatch, one instance per thread (`csrc/megakernel.cu`,
bound in `ipm/_cuda.py`), and on the CPU as its plain PyTorch version
(`ipm/megakernel_ref.py`).  This module holds what surrounds both: the
eligibility rule, the host-side packing of the data into component-major,
lane-minor flats with batch-constant components passed once, the output
row layout, and the lazily materialized outputs.

Dispatch: the batch goes to the kernel in chunks of lanes, as in the
reference (`_chunk_lanes`, `solve`; clarabel_tpu/ipm/megakernel.py:
3692-3790): on a card, chunk k+1 is staged in pinned host memory and copied
on a copy stream while chunk k's kernel runs on the current stream, events
ordering the two.  The chunk rule keeps the reference's structure (a byte
budget, a batch-aware power of two of 1024-lane blocks) with the constants
measured on the card (`chunk_lanes`; PERF.md section 5).  The outputs of
every chunk are gathered on the device, then fetched once (the eager
fields) and once more when a lazy field is first read.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..cones.api import (ExponentialConeT, GenPowerConeT, NonnegativeConeT,
                         PowerConeT, PSDTriangleConeT, SecondOrderConeT,
                         ZeroConeT)
from ..cones.layout import ConeLayout
from ..settings import Settings
from . import megakernel_ref

# per-lane data widths the kernel takes (see `eligible`)
S8, L128 = 8, 128


def _vmem_estimate_bytes(n: int, m: int) -> int:
    """The reference's per-block working-set bound (kept as the
    eligibility rule until the port sets a Hopper bound)."""
    rows = (
        2 * (n * n + n * m + n + m)
        + 2 * n * m
        + 2 * n * n
        + 4 * n * m
        + 20 * (n + 2 * m)
        + 120
    )
    return rows * S8 * L128 * 4


def eligible(layout: ConeLayout, settings: Settings, n: int) -> bool:
    """The reference's rule for the megakernel regime: small dense
    problems at float64, without verbose or mixed precision, with at least
    one barrier cone; PSD sides at most 3 and genpow widths at most 16,
    both charged against the budget of nonsymmetric segments."""
    if settings.dtype != "float64":
        return False
    if settings.verbose or settings.mixed_precision:
        return False
    m = layout.m
    if n < 1 or m < 1 or n > 32 or m > 96 or n * m > 2048:
        return False
    if _vmem_estimate_bytes(n, m) > 12 * 1024 * 1024:
        return False
    n_nonsym = 0
    for c in layout.cones:
        name = type(c).__name__
        if name not in ("ZeroConeT", "NonnegativeConeT", "SecondOrderConeT",
                        "ExponentialConeT", "PowerConeT", "GenPowerConeT",
                        "PSDTriangleConeT"):
            return False
        if isinstance(c, SecondOrderConeT) and c.dim < 2:
            return False
        if name in ("ExponentialConeT", "PowerConeT"):
            n_nonsym += 1
        if name == "GenPowerConeT":
            w_g = len(c.alpha) + c.dim2
            if w_g > 16:
                return False
            n_nonsym += 1 + w_g // 3
        if name == "PSDTriangleConeT":
            if c.dim > 3:
                return False
            n_nonsym += 1 + (c.dim * c.dim) // 3
    if n_nonsym > 16:
        return False
    if (_vmem_estimate_bytes(n, m) + n_nonsym * 48 * S8 * L128 * 4
            > 12 * 1024 * 1024):
        return False
    if layout.degree < 1:
        return False
    return True


_KINDS = {ZeroConeT: "zero", NonnegativeConeT: "nn", SecondOrderConeT: "soc",
          ExponentialConeT: "exp", PowerConeT: "pow", GenPowerConeT: "genpow",
          PSDTriangleConeT: "psd"}


@dataclasses.dataclass(frozen=True)
class MegaSpec:
    """What the kernel is specialised to: the shape, the cone segments
    (kind, lo, hi), each segment's power-cone exponent (0 for the other
    kinds), each segment's generalized-power exponents (() for the other
    kinds; the segment's dim2 is its width less their count), the cap on
    the Jacobi sweeps of PSD segments, the float32 first phase (K1e) as
    `make_spec` resolves it, and the settings.  A PSD segment's side
    follows from its width."""

    n: int
    m: int
    segs: Tuple[Tuple[str, int, int], ...]
    degree: int
    p_nonzero: bool
    st: Settings
    alphas: Tuple[float, ...]
    gp_alphas: Tuple[Tuple[float, ...], ...]
    # the most Jacobi sweeps of a PSD segment's SVD and eigenvalues; they
    # stop earlier once no pair rotates (DEVIATIONS.md #12)
    psd_sweeps: int = megakernel_ref.JACOBI_SWEEPS
    # the float32 first phase: on, the mu below which a lane hands off to
    # the float64 loop, and the most iterations a lane spends in it
    two_phase: bool = False
    switch_mu: float = 1e-3
    p1_cap: int = megakernel_ref.P1_CAP

    def has(self, *kinds) -> bool:
        return any(k in kinds for k, _, _ in self.segs)

    @property
    def nonsym(self) -> bool:
        """The layout has a nonsymmetric segment: exp, pow (K1b) or
        genpow (K1c)."""
        return self.has("exp", "pow", "genpow")

    @property
    def outd(self) -> int:
        return self.n + 2 * self.m + 13

    @property
    def triu(self) -> int:
        return self.n * (self.n + 1) // 2

    @property
    def p_gather(self) -> Tuple[int, ...]:
        """Column-major triu flat -> full column-major n x n map,
        tri(i, j) = j(j+1)/2 + i for i <= j."""
        n = self.n
        return tuple((j * (j + 1)) // 2 + i if i <= j
                     else (i * (i + 1)) // 2 + j
                     for j in range(n) for i in range(n))


def make_spec(layout: ConeLayout, settings: Settings, n: int,
              p_nonzero: bool = True) -> MegaSpec:
    segs, alphas, gp_alphas = [], [], []
    for cone, (lo, hi) in zip(layout.cones, layout.ranges):
        segs.append((_KINDS[type(cone)], lo, hi))
        alphas.append(float(cone.alpha) if isinstance(cone, PowerConeT)
                      else 0.0)
        gp_alphas.append(tuple(float(a) for a in cone.alpha)
                         if isinstance(cone, GenPowerConeT) else ())
    # the reference keeps the float32 phase off where zero-cone rows (1/eps
    # in the condensed system) or nonsymmetric segments would break it
    # (clarabel_tpu/ipm/megakernel.py:549-570)
    kinds = {k for k, _, _ in segs}
    two_phase = bool(settings.megakernel_two_phase) and not (
        kinds & {"zero", "exp", "pow", "genpow"})
    return MegaSpec(n, layout.m, tuple(segs), layout.degree,
                    bool(p_nonzero), settings, tuple(alphas),
                    tuple(gp_alphas), two_phase=two_phase,
                    switch_mu=float(settings.megakernel_switch_mu),
                    p1_cap=min(megakernel_ref.P1_CAP, int(settings.max_iter)))


REST_NAMES = ["obj_val_dual", "r_prim", "r_dual", "gap_abs", "gap_rel",
              "mu", "step_length", "sigma", "ktratio", "tau", "kappa",
              "raw_status", "p1_iterations"]


def _as_host(P, q, A, b):
    return tuple(np.asarray(x, np.float64) for x in (P, q, A, b))


def is_const(arr) -> bool:
    """Every batch entry equals the first: the cheap arr[1] probe rejects
    a varying batch before the full scan."""
    return (arr.shape[0] > 1 and np.array_equal(arr[1], arr[0])
            and bool((arr == arr[0]).all()))


def _triu_ij(n: int):
    return (np.concatenate([np.arange(j + 1) for j in range(n)]),
            np.concatenate([np.full(j + 1, j) for j in range(n)]))


def _host_exts(spec: MegaSpec):
    """Per component, raw (b, ...) host array -> its (b, d) flat rows."""
    n, m = spec.n, spec.m
    tri_i, tri_j = _triu_ij(n)
    return [
        lambda x: x[:, tri_i, tri_j],
        lambda x: x.reshape(len(x), n),
        lambda x: x.transpose(0, 2, 1).reshape(len(x), n * m),
        lambda x: x.reshape(len(x), m),
    ]


def _lane_minor(rows):
    """(b, d) -> a new (d, b) tensor with unit lane stride, also at b = 1
    (where `.T.contiguous()` keeps the view's strides)."""
    out = rows.new_empty((rows.shape[1], rows.shape[0]))
    return out.copy_(rows.T)


def _device_exts(spec: MegaSpec, device):
    """Per component, raw (b, ...) tensor -> its (d, b) lane-minor flat, by
    indexing and transposes on the tensor's device: the same values as
    the host's exts (no arithmetic), so the same bits."""
    n, m = spec.n, spec.m
    tri_i, tri_j = (torch.from_numpy(t).to(device) for t in _triu_ij(n))
    return [
        lambda x: _lane_minor(x[:, tri_i, tri_j]),
        lambda x: _lane_minor(x.reshape(len(x), n)),
        lambda x: _lane_minor(x.transpose(1, 2).reshape(len(x), n * m)),
        lambda x: _lane_minor(x.reshape(len(x), m)),
    ]


def shared_flats(raws, const, spec: MegaSpec, device):
    """The batch-constant components' (d,) flats on `device` (None where a
    component varies)."""
    exts = _host_exts(spec)
    return [torch.from_numpy(np.ascontiguousarray(ext(raw[:1])[0])).to(device)
            if c else None for raw, c, ext in zip(raws, const, exts)]


def host_pack(raws, const, spec: MegaSpec, lo: int, hi: int):
    """Lanes lo:hi of the varying components packed on the host into one
    (sum of d, hi - lo) array, rows in component order."""
    parts = [ext(raw[lo:hi]) for raw, c, ext in
             zip(raws, const, _host_exts(spec)) if not c]
    out = np.empty((sum(f.shape[1] for f in parts), hi - lo))
    off = 0
    for f in parts:
        out[off:off + f.shape[1]] = f.T
        off += f.shape[1]
    return out


def split_packed(dev_packed, const, spec: MegaSpec):
    """(sum of d, b) packed rows -> the varying components' flats (row
    blocks of it, None for the batch-constant ones)."""
    dims = (spec.triu, spec.n, spec.n * spec.m, spec.m)
    flats, off = [], 0
    for c, d in zip(const, dims):
        if c:
            flats.append(None)
        else:
            flats.append(dev_packed[off:off + d])
            off += d
    return flats


def prepare(P, q, A, b, spec: MegaSpec, device):
    """Host arrays -> the kernel's four input flats on `device`, for one
    dispatch over the whole batch.

    P may be full-symmetric or upper-triangular: only its upper triangle
    is read.  A component whose every batch entry is identical is passed
    once, as a 1-D (d,) tensor (lane stride 0 in the kernel); the varying
    ones are packed into one (sum of d, B) host array, moved in one copy,
    and handed on as contiguous row blocks of it.  Returns
    (B, [Ptri, q, A, b])."""
    raws = _as_host(P, q, A, b)
    B = raws[1].shape[0]
    const = [is_const(r) for r in raws]
    flats = shared_flats(raws, const, spec, device)
    if not all(const):
        dev_packed = torch.from_numpy(
            host_pack(raws, const, spec, 0, B)).to(device)
        for i, f in enumerate(split_packed(dev_packed, const, spec)):
            if f is not None:
                flats[i] = f
    return B, flats


# ---- the chunk rule (the reference's `_chunk_lanes`,
# clarabel_tpu/ipm/megakernel.py:3692-3718), its constants measured on the
# H100 (run H1 of `tools/host_probe.py`, PERF.md section 5): a chunk below
# 16384 lanes leaves the card's SMs idle (bench at 131072, device packing:
# 16 chunks of 8192 lanes 60.5 ms wall, 8 of 16384 50.2, 4 of 32768 47.5,
# one dispatch 53.4; psd3 50.4, 32.6, 37.3, 48.7), and at B = 4096 one
# dispatch beat two chunks on bench, psd3 and exp ----
BLOCK = 1024                  # lanes per block of the rule
CHUNK_BYTE_BUDGET = 1 << 30   # bytes staged per dispatch
CHUNK_WORK_FACTOR = 4         # inputs, kernel state and kept outputs
CHUNK_MAX_BLOCKS = 64         # the largest chunk, in blocks
CHUNKS_PER_BATCH = 8          # a batch is cut into about this many chunks
CHUNK_MIN_BLOCKS = 16         # ... of at least this many blocks


def chunk_lanes(packed_width: int, total_lanes: int) -> int:
    """Lanes per dispatch for a batch of `total_lanes` whose varying
    components are `packed_width` values a lane: a power of two of BLOCK
    lanes within the byte budget and CHUNK_MAX_BLOCKS, grown with the
    batch (about CHUNKS_PER_BATCH chunks, at least CHUNK_MIN_BLOCKS
    blocks)."""
    lane_bytes = max(packed_width, 1) * 8 * CHUNK_WORK_FACTOR
    blocks = max(1, CHUNK_BYTE_BUDGET // (lane_bytes * BLOCK))
    blocks = 1 << min(int(blocks).bit_length() - 1,
                      CHUNK_MAX_BLOCKS.bit_length() - 1)
    want = max(CHUNK_MIN_BLOCKS,
               min(blocks, total_lanes // (CHUNKS_PER_BATCH * BLOCK)))
    want = 1 << (want.bit_length() - 1)
    return min(blocks, want) * BLOCK


_COPY_STREAMS = {}


def _copy_stream(device):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _COPY_STREAMS:
        _COPY_STREAMS[index] = torch.cuda.Stream(device=index)
    return _COPY_STREAMS[index]


def _stage(arrays, device, copy_stream, compute_stream):
    """Host arrays -> tensors on `device`.  On a card each array is staged
    in pinned memory and copied on `copy_stream`; the compute stream
    waits for the copy's event, and the tensors are marked as used there.
    Returns (tensors, the pinned buffers, which must outlive the copy)."""
    if device.type != "cuda":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], []
    pinned = []
    for a in arrays:
        buf = torch.empty(a.shape, dtype=torch.float64, pin_memory=True)
        buf.numpy()[...] = a
        pinned.append(buf)
    with torch.cuda.stream(copy_stream):
        outs = [buf.to(device, non_blocking=True) for buf in pinned]
        done = torch.cuda.Event()
        done.record(copy_stream)
    compute_stream.wait_event(done)
    for t in outs:
        t.record_stream(compute_stream)
    return outs, pinned


def staged_chunks(P, q, A, b, spec: MegaSpec, device, chunk=None):
    """Host arrays -> the kernel's input flats on `device`, chunk by chunk:
    yields (lo, hi, flats of lanes lo:hi, the pinned buffers, which must
    outlive the chunk's copy).  `chunk`: lanes a chunk (None: the rule,
    `chunk_lanes`).  The batch-constant components are passed once; each
    chunk's varying ones are copied raw (on a card from pinned memory, on
    the copy stream) and gathered into lane-minor flats on the device.
    The host stages chunk k+1 while the caller's launch of chunk k runs."""
    device = torch.device(device)
    raws = _as_host(P, q, A, b)
    B = raws[1].shape[0]
    const = [is_const(r) for r in raws]
    flats = shared_flats(raws, const, spec, device)
    dims = (spec.triu, spec.n, spec.n * spec.m, spec.m)
    width = sum(d for d, c in zip(dims, const) if not c)
    C = chunk_lanes(width, B) if chunk is None else max(1, int(chunk))
    on_card = device.type == "cuda"
    copy_stream = _copy_stream(device) if on_card else None
    compute = torch.cuda.current_stream(device) if on_card else None
    dev_exts = _device_exts(spec, device)
    idx = [i for i, c in enumerate(const) if not c]
    for lo in range(0, B, C):
        hi = min(B, lo + C)
        cf, pinned = list(flats), []
        if idx:
            staged, pinned = _stage([raws[i][lo:hi] for i in idx], device,
                                    copy_stream, compute)
            for i, t in zip(idx, staged):
                cf[i] = dev_exts[i](t)
        yield lo, hi, cf, pinned


def solve_flats(Ptri, q, A, b, spec: MegaSpec, B: int):
    """The megakernel wrapper over B lanes: on CUDA tensors it launches
    the kernel (or raises), the library a batch of B lanes takes; on CPU
    tensors it runs the plain PyTorch version.
    B is passed, not read from the flats: every flat may be a
    batch-constant (d,) one.  Returns (vals (OUTD, B) float64, ints (4, B)
    int32: status, iterations, final scaling strategy, iterations of the
    float32 first phase)."""
    devs = {t.device.type for t in (Ptri, q, A, b)}
    if devs == {"cuda"}:
        from . import _cuda

        return _cuda.megakernel(Ptri, q, A, b, spec, B)
    if devs == {"cpu"}:
        return megakernel_ref.mega_solve_plain(Ptri, q, A, b, spec, B)
    raise ValueError(f"inputs on mixed devices: {sorted(devs)}")


def split_outputs(vals, ints, spec: MegaSpec):
    """(OUTD, B), (4, B) -> the eager block (x, obj_val, status,
    iterations; (n+3, B) float64) and the rest (z, s, diagnostics, the
    iterations of the float32 first phase last), both lane-minor on the
    device."""
    n, k = spec.n, spec.n + 2 * spec.m
    eager = torch.cat([vals[:n], vals[k:k + 1], ints[:2].to(vals.dtype)],
                      dim=0)
    rest = torch.cat([vals[n:k], vals[k + 1:], ints[3:4].to(vals.dtype)],
                     dim=0)
    return eager, rest


def unpack_eager(e, n: int) -> dict:
    """Host-side unpack of the (n+3, B) eager block."""
    e = np.asarray(e).T
    return {
        "x": e[:, :n],
        "obj_val": e[:, n],
        "status": e[:, n + 1].astype(np.int64),
        "iterations": e[:, n + 2].astype(np.int64),
    }


def unpack_rest(r, m: int) -> dict:
    """Host-side unpack of the lazily fetched block (z, s, diagnostic
    scalars)."""
    r = np.asarray(r).T
    out = {"z": r[:, :m], "s": r[:, m:2 * m]}
    for i, nm in enumerate(REST_NAMES):
        out[nm] = r[:, 2 * m + i]
    return out


class LazyOutputs(dict):
    """Solver-output dict whose rarely read fields (z, s, diagnostic
    scalars) stay on the device until first accessed.  Lane merges from a
    rescue pass are recorded and applied at materialization, so a rescue
    does not force the fetch."""

    def __init__(self, eager: dict, lazy_keys, fetch):
        super().__init__(eager)
        self._lazy_keys = tuple(lazy_keys)
        self._fetch = fetch
        self._pending = []   # (take_idx, sel_idx, rescue_out)

    def _merge(self, take, sel, rout):
        for k in self._lazy_keys:
            if k in rout and dict.__contains__(self, k):
                merged = np.array(dict.__getitem__(self, k))
                merged[take] = rout[k][sel]
                dict.__setitem__(self, k, merged)

    def _materialize(self):
        if self._fetch is not None:
            rest = self._fetch()
            self._fetch = None
            self.update(rest)
            for take, sel, rout in self._pending:
                self._merge(take, sel, rout)
            self._pending = []

    def __getitem__(self, k):
        if not dict.__contains__(self, k) and k in self._lazy_keys:
            self._materialize()
        return dict.__getitem__(self, k)

    def merge_lanes(self, take, sel, rout):
        """Merge a rescue's lazy fields: lanes `take` get rout[k][sel].
        Deferred until materialization when the fields are still on the
        device (the caller merges the eager fields itself)."""
        take, sel = np.asarray(take), np.asarray(sel)
        if self._fetch is None:
            self._merge(take, sel, rout)
        else:
            self._pending.append((take, sel, rout))


def build_mega_solve(layout: ConeLayout, settings: Settings, n: int,
                     p_nonzero: bool = True,
                     device: Optional[torch.device] = None,
                     chunk: Optional[int] = None):
    """Returns solve(P, q, A, b) over batch-major (B, ...) host arrays,
    yielding the reference's output dict (a LazyOutputs).

    `chunk`: lanes per dispatch (None: `chunk_lanes`, the measured rule;
    a value at least B makes one dispatch).  Each chunk copies the raw
    (b, ...) arrays of its varying components and gathers them into
    lane-minor flats on the device, which was faster than the numpy
    packing of `prepare` at 131072 lanes on bench, psd3 and exp (wall 53.4
    against 87.2, 48.7 against 111.6, 14.4 against 21.9 ms in one
    dispatch) and within the turns' spread at 4096 (run H1, PERF.md
    section 5).  A chunk launches the library of its own size, which was
    the faster where the two differ (DEVIATIONS.md #7)."""
    spec = make_spec(layout, settings, n, p_nonzero)
    device = torch.device(device) if device is not None else \
        torch.device("cuda")

    def solve(P, q, A, b):
        outs, keep = [], []
        for lo, hi, cf, pinned in staged_chunks(P, q, A, b, spec, device,
                                                chunk):
            outs.append(solve_flats(*cf, spec, hi - lo))
            keep += pinned
        vals = torch.cat([v for v, _ in outs], dim=1) if len(outs) > 1 \
            else outs[0][0]
        ints = torch.cat([i for _, i in outs], dim=1) if len(outs) > 1 \
            else outs[0][1]
        eager, rest = split_outputs(vals, ints, spec)
        out = unpack_eager(eager.cpu().numpy(), n)
        del keep   # the eager fetch waited for every copy

        def fetch_rest():
            return unpack_rest(rest.cpu().numpy(), spec.m)

        return LazyOutputs(out, REST_NAMES + ["z", "s"], fetch_rest)

    solve.spec = spec
    return solve
