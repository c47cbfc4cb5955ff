"""The megakernel's host side: chunked dispatch and device-side packing.

The port cuts a batch into chunks of lanes (`ipm/megakernel.build_mega_solve`
`chunk=`) and packs each chunk's data on the device.  Lanes are
independent, so a chunked solve must give, lane for lane, the bits of one
host-packed dispatch over the whole batch (`megakernel.prepare`): statuses, iterations, x, z, s
and every lazily fetched field.  Here the kernel's plain version runs on
the CPU, as `BatchSolver(..., device="cpu")` runs it.
"""

import numpy as np
import pytest
import torch

import clarabel_tpu_torch as ctt
from clarabel_tpu_torch import bench_data
from clarabel_tpu_torch.cones.api import cones_collapse
from clarabel_tpu_torch.cones.layout import ConeLayout
from clarabel_tpu_torch.ipm import megakernel

N = 6
NN_SOC = [ctt.NonnegativeConeT(N), ctt.SecondOrderConeT(N + 1)]
CASES = {
    "bench": (NN_SOC, N, lambda B: bench_data.make_batch(B, N, 0)),
    "qp_eq": ([ctt.ZeroConeT(1), ctt.NonnegativeConeT(N + 1)], N,
              lambda B: bench_data.make_qp_eq(B, N, 1)),
    "exp": ([ctt.NonnegativeConeT(2), ctt.ExponentialConeT()], 3,
            lambda B: bench_data.make_exp_batch(B)),
}
FIELDS = ["x", "obj_val", "status", "iterations", "z", "s"] + \
    megakernel.REST_NAMES
SETTINGS = ctt.Settings(kkt_backend="megakernel")


def _solver(name, **kw):
    cones, n, _ = CASES[name]
    layout = ConeLayout(cones_collapse(list(cones)))
    return megakernel.build_mega_solve(layout, SETTINGS, n, device="cpu",
                                       **kw)


_ONE = {}


def _one_dispatch(name, B):
    """The whole batch in one dispatch, packed on the host by `prepare`
    (cached per case)."""
    if (name, B) not in _ONE:
        data = CASES[name][2](B)
        spec = _solver(name).spec
        got, flats = megakernel.prepare(*data, spec, "cpu")
        assert got == B
        vals, ints = megakernel.solve_flats(*flats, spec, B)
        eager, rest = megakernel.split_outputs(vals, ints, spec)
        out = megakernel.unpack_eager(eager.numpy(), spec.n)
        out.update(megakernel.unpack_rest(rest.numpy(), spec.m))
        _ONE[name, B] = (data, {k: np.array(out[k]) for k in FIELDS})
    return _ONE[name, B]


def _assert_same_bits(got, ref):
    for k in FIELDS:
        a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert a.tobytes() == b.tobytes(), k


# (case, B, chunk): three chunk sizes on each case, each leaving a last
# chunk shorter than the others.  The chunks are
# multiples of 16 lanes, as every chunk of the rule is (1024-lane blocks):
# PyTorch's CPU sum over the component axis adds in a vector body across
# lanes and a scalar tail in different orders, so the plain version keeps
# a lane's bits where the lane keeps its place in the vectors (a chunk of
# 33 moves lanes 32, 65, 96 and 97 of 100 in their last bit;
# DEVIATIONS.md #7).  On the card each lane is its own thread or group.
CHUNKED = [
    ("bench", 100, 16), ("bench", 100, 32), ("bench", 100, 48),
    ("qp_eq", 72, 16), ("qp_eq", 72, 32), ("qp_eq", 72, 48),
    ("exp", 80, 32), ("exp", 80, 48), ("exp", 80, 64),
]


@pytest.mark.parametrize("name,B,chunk", CHUNKED)
def test_chunked_equals_one_dispatch(name, B, chunk):
    data, ref = _one_dispatch(name, B)
    out = _solver(name, chunk=chunk)(*data)
    assert isinstance(out, megakernel.LazyOutputs)
    _assert_same_bits(out, ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_packing_gives_the_host_flats(name):
    """The triu gather and the transposes on the device give the host's
    packed flats bit for bit; batch-constant components stay (d,)."""
    cones, n, make = CASES[name]
    spec = _solver(name).spec
    raws = megakernel._as_host(*make(37))
    # a full-symmetric P: the kernel reads only its upper triangle
    const = [megakernel.is_const(r) for r in raws]
    host = megakernel.split_packed(
        torch.from_numpy(megakernel.host_pack(raws, const, spec, 5, 30)),
        const, spec)
    exts = megakernel._device_exts(spec, torch.device("cpu"))
    for i, c in enumerate(const):
        if c:
            assert host[i] is None
            continue
        dev = exts[i](torch.from_numpy(raws[i][5:30]))
        assert dev.shape == host[i].shape
        assert torch.equal(dev, host[i])
        # unit lane stride, which the CUDA wrapper requires, also for a
        # chunk of one lane
        one = exts[i](torch.from_numpy(raws[i][5:6]))
        assert dev.stride(1) == 1 and one.stride() == (1, 1)
    B, flats = megakernel.prepare(*raws, spec, "cpu")
    assert B == 37
    for i, c in enumerate(const):
        assert flats[i].dim() == (1 if c else 2)
    assert const[2], "the batch-constant A of the bench batches"


def test_chunk_rule():
    """The reference's rule: a power of two of 1024-lane blocks, at least
    CHUNK_MIN_BLOCKS, about CHUNKS_PER_BATCH chunks a batch, within
    CHUNK_MAX_BLOCKS and the byte budget."""
    blk = megakernel.BLOCK
    lo = megakernel.CHUNK_MIN_BLOCKS * blk
    hi = megakernel.CHUNK_MAX_BLOCKS * blk
    for B in (1, 4096, 65536, 131072, 1 << 20, 1 << 24):
        c = megakernel.chunk_lanes(40, B)
        assert c % blk == 0 and (c // blk) & (c // blk - 1) == 0
        assert lo <= c <= max(lo, hi)
    # one dispatch up to the smallest chunk; 8 chunks at 131072 lanes
    assert megakernel.chunk_lanes(40, 4096) >= 4096
    assert megakernel.chunk_lanes(40, 131072) == 131072 // 8
    assert megakernel.chunk_lanes(40, 1 << 24) == hi
    # a lane too wide for the budget: one block
    assert megakernel.chunk_lanes(1 << 20, 1 << 20) == blk


def test_rescue_after_a_chunked_solve():
    """`merge_lanes` after a chunked solve still closes rescued lanes: a
    cut iteration cap leaves lanes, the rescue closes them, and the lazy
    fields read after it carry the rescue's values."""
    P, q, A, b = bench_data.make_batch(48, N, 0)
    cut = ctt.Settings(kkt_backend="megakernel", max_iter=6)
    bs = ctt.BatchSolver(NN_SOC, N, cut, rescue="cpu",
                         rescue_settings=ctt.Settings(), device="cpu")
    bs._mega_fn = megakernel.build_mega_solve(
        bs.layout, cut, N, device="cpu", chunk=20)
    raw = bs._mega_fn(P, q, A, b)
    left = np.nonzero(raw["status"] != int(ctt.SolverStatus.SOLVED))[0]
    assert len(left) > 0
    sol = bs.solve(P, q, A, b)
    assert sol.all_solved
    # the rescued lanes' z/s are the rescue's, not the kernel's
    assert not np.array_equal(sol.z[left], np.asarray(raw["z"])[left])
    assert np.all(sol.r_prim[left] < 1e-7)
