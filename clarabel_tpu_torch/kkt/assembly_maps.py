"""Map-based block-arrow KKT assembly for sparse problem data, batched over
a leading lane axis.

A port of `clarabel_tpu/kkt/assembly_maps.py`, the counterpart of the
reference's one-pass CSC structural assembly with per-source index maps
(reference: src/kktsolvers/direct-ldl/directldl_kkt_assembly.jl,
directldl_datamaps.jl): at setup the host computes, for every structural
nonzero of the KKT matrix

    K = [ P   Aᵀ ]
        [ A  −Hs ]

its destination inside the packed block-arrow buffers (diagonal blocks D,
couplings B, tail C of a BlockArrowPlan).  Per iteration the device sums
the concatenated source values [P_vals; A_vals; A_vals; −Hs_vals] into
those destinations, in a fixed order (`linalg.matops.SegmentSum`): no
dense K and no dense Hs is ever formed, so the problem size is bounded by
the pattern, not N².
"""

import dataclasses

import numpy as np
import torch

from ..cones import ops as cone_ops
from ..cones.layout import ConeLayout
from ..linalg.matops import SegmentSum, on_device
from ..settings import torch_dtype
from ..structure import BlockArrowPlan


@dataclasses.dataclass
class AssemblyMaps:
    dest: np.ndarray         # (n_src,) flat index into [D|B|C] buffer (OOB = drop)
    pad_diag_dest: np.ndarray  # positions of padded diagonal unit pivots
    diag_dest: np.ndarray    # (N,) destination of each true KKT diagonal
    diag_signs: np.ndarray   # (N,) ±1 in KKT row order
    n_P: int
    n_A: int
    n_hs: int
    plan: BlockArrowPlan
    # rank-2 SOC threshold used when emitting Hs coords (None = dense
    # per-cone Hs blocks); must match the hs_flat_values call at solve
    soc_rank2_min_dim: "int | None" = None

    def summer(self) -> SegmentSum:
        """The fixed-order sum of the sources into the buffer, made once."""
        s = self.__dict__.get("_summer")
        if s is None:
            s = SegmentSum(self.dest, self.buf_size)
            self._summer = s
        return s

    @property
    def buf_size(self) -> int:
        p, nb, nt = self.plan.p, self.plan.nb, self.plan.nt
        return p * nb * nb + p * nb * nt + nt * nt

    @property
    def key(self):
        import hashlib

        h = hashlib.sha1()
        for a in (self.dest, self.diag_dest, self.diag_signs):
            h.update(np.ascontiguousarray(a).tobytes())
        return (self.n_P, self.n_A, self.n_hs, h.hexdigest(),
                self.soc_rank2_min_dim, self.plan.key)


def build_assembly_maps(P_pattern, A_pattern, layout: ConeLayout,
                        plan: BlockArrowPlan,
                        soc_rank2_min_dim=None) -> AssemblyMaps:
    """P_pattern/A_pattern: (rows, cols) of structural nonzeros; P must be
    the FULL symmetric pattern."""
    n, m = plan.n, plan.m
    N = n + m
    p, nb, nt = plan.p, plan.nb, plan.nt
    base_B = p * nb * nb
    base_C = base_B + p * nb * nt
    buf_size = base_C + nt * nt
    DROP = buf_size

    # row -> (is_tail, part, position)
    where_part = np.full(N, -1, dtype=np.int64)
    where_pos = np.full(N, -1, dtype=np.int64)
    for i in range(p):
        rows = plan.block_idx[i]
        real = rows[rows < N]
        where_part[real] = i
        where_pos[real] = np.arange(len(real))
    is_tail = np.zeros(N, dtype=bool)
    is_tail[plan.tail_idx] = True
    tail_pos = np.full(N, -1, dtype=np.int64)
    tail_pos[plan.tail_idx] = np.arange(nt)

    def dest_of(r, c):
        """Vectorized destination computation for KKT coords (r, c);
        entries with r or c out of range (sentinel) drop."""
        r = np.asarray(r, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        oob = (r >= N) | (c >= N)
        rs = np.where(oob, 0, r)
        cs = np.where(oob, 0, c)
        rt, ct = is_tail[rs], is_tail[cs]
        out = np.full(r.shape, DROP, dtype=np.int64)

        both_blk = ~rt & ~ct & ~oob
        same = both_blk & (where_part[rs] == where_part[cs])
        out[same] = (
            where_part[rs[same]] * nb * nb
            + where_pos[rs[same]] * nb + where_pos[cs[same]]
        )
        cross = both_blk & (where_part[rs] != where_part[cs])
        if np.any(cross):
            raise ValueError(
                "KKT entry couples two different blocks: partition invalid"
            )
        bt = ~rt & ct & ~oob
        out[bt] = (
            base_B + where_part[rs[bt]] * nb * nt
            + where_pos[rs[bt]] * nt + tail_pos[cs[bt]]
        )
        # (tail, block) is the mirror of (block, tail): implied, drop
        tt = rt & ct & ~oob
        out[tt] = base_C + tail_pos[rs[tt]] * nt + tail_pos[cs[tt]]
        return out

    Pr, Pc = P_pattern
    Ar, Ac = A_pattern
    hr, hc = cone_ops.hs_coords(layout, n, soc_rank2_min_dim=soc_rank2_min_dim)

    dests = [
        dest_of(Pr, Pc),                    # P block (full symmetric)
        dest_of(np.asarray(Ar) + n, Ac),    # A lower-left
        dest_of(np.asarray(Ac), np.asarray(Ar) + n),  # Aᵀ upper-right
        dest_of(hr, hc),                    # −Hs (sign applied device-side)
    ]
    dest = np.concatenate(dests)

    # identity pivots at padded diagonal positions of D (as an index
    # list — a dense buffer-sized init would become a huge HLO constant)
    pad_diag = []
    for i in range(p):
        rows = plan.block_idx[i]
        for j in range(nb):
            if rows[j] >= N:
                pad_diag.append(i * nb * nb + j * nb + j)
    pad_diag_dest = np.asarray(pad_diag, dtype=np.int64)

    diag_dest = dest_of(np.arange(N), np.arange(N))
    assert not np.any(diag_dest == DROP)
    diag_signs = np.concatenate([np.ones(n), -np.ones(m)])

    return AssemblyMaps(
        dest=dest, pad_diag_dest=pad_diag_dest, diag_dest=diag_dest,
        diag_signs=diag_signs, n_P=len(Pr), n_A=len(Ar),
        n_hs=len(hr), plan=plan, soc_rank2_min_dim=soc_rank2_min_dim,
    )


def assemble_blocks(maps: AssemblyMaps, P_vals, A_vals, hs_vals, settings,
                    factor_dtype):
    """Device side: the sources (B, ·) summed into the (D, Bc, C) block
    arrays, with the static regularization on the true diagonal."""
    plan = maps.plan
    p, nb, nt = plan.p, plan.nb, plan.nt
    dtype = torch_dtype(factor_dtype)
    B = P_vals.shape[0]

    src = torch.cat([P_vals, A_vals, A_vals, -hs_vals], dim=1).to(dtype)
    buf = maps.summer()(src)
    dev = buf.device
    if len(maps.pad_diag_dest):
        # index_fill_: a scalar assigned through an index would be copied
        # from the host, which a CUDA graph cannot capture
        buf.index_fill_(1, on_device(maps, "pad_diag_dest", dev), 1.0)

    # static regularization ±eps on the true diagonal
    if settings.static_regularization_enable:
        dd = on_device(maps, "diag_dest", dev)
        maxdiag = buf[:, dd].abs().amax(dim=1)
        eps = (settings.static_regularization_constant
               + settings.static_regularization_proportional * maxdiag)
        buf[:, dd] += (on_device(maps, "diag_signs", dev).to(dtype)
                       * eps[:, None])

    base_B = p * nb * nb
    base_C = base_B + p * nb * nt
    D = buf[:, :base_B].reshape(B, p, nb, nb)
    Bc = buf[:, base_B:base_C].reshape(B, p, nb, nt)
    C = buf[:, base_C:].reshape(B, nt, nt)
    return D, Bc, C


def factor_from_maps(maps: AssemblyMaps, P_vals, A_vals, hs_vals, settings,
                     factor_dtype, group=None):
    """Assemble and factor (the factor is kkt.blockarrow's).  With a
    `group` (the tp axis of a mesh) every rank assembles the whole buffer
    and factors its own blocks (DEVIATIONS.md #20); all-sentinel padded
    blocks come out of the assembly as exact identities (pad_diag_dest
    sets their unit pivots, every other entry drops)."""
    from .blockarrow import factor_blocks, local_blocks

    plan = maps.plan
    D, Bc, C = assemble_blocks(maps, P_vals, A_vals, hs_vals, settings,
                               factor_dtype)
    dev, dtype = D.device, D.dtype
    lo, hi = local_blocks(plan.p, group)
    return factor_blocks(D[:, lo:hi], Bc[:, lo:hi], C,
                         on_device(plan, "block_signs", dev)[lo:hi].to(dtype),
                         on_device(plan, "tail_signs", dev).to(dtype),
                         settings, group)
