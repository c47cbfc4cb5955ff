"""Solver settings: a copy of the reference package's `Settings`.

Same field names, the same defaults and the same comments, so that one
settings object (as a dict) configures both packages (`interop.py`).  Many
fields name paths of the single-instance `Solver`, which the port does not
have yet; `parallel/batch_impl.BatchSolver`, like the reference's, does not
read them.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a `dtype`/`factor_dtype` setting."""
    return {"float32": torch.float32, "float64": torch.float64}[str(name)]


@dataclasses.dataclass
class Settings:
    # main iteration controls (reference: src/settings.jl:72-75)
    max_iter: int = 200
    time_limit: float = float("inf")
    verbose: bool = False
    max_step_fraction: float = 0.99

    # full accuracy tolerances (reference: src/settings.jl:78-83)
    tol_gap_abs: float = 1e-8
    tol_gap_rel: float = 1e-8
    tol_feas: float = 1e-8
    tol_infeas_abs: float = 1e-8
    tol_infeas_rel: float = 1e-8
    tol_ktratio: float = 1e-6

    # reduced accuracy tolerances (reference: src/settings.jl:90-95)
    reduced_tol_gap_abs: float = 5e-5
    reduced_tol_gap_rel: float = 5e-5
    reduced_tol_feas: float = 1e-4
    reduced_tol_infeas_abs: float = 5e-12
    reduced_tol_infeas_rel: float = 5e-5
    reduced_tol_ktratio: float = 1e-4

    # data equilibration (reference: src/settings.jl:98-101)
    equilibrate_enable: bool = True
    equilibrate_max_iter: int = 10
    equilibrate_min_scaling: float = 1e-4
    equilibrate_max_scaling: float = 1e4

    # cones and line search (reference: src/settings.jl:104-106)
    linesearch_backtrack_step: float = 0.8
    min_switch_step_length: float = 1e-1
    min_terminate_step_length: float = 1e-4

    # linear solver selection.  "dense" = dense quasidefinite LDL kernel,
    # "auto" resolves by problem structure at setup time.
    direct_solve_method: str = "auto"

    # static regularization (reference: src/settings.jl:117-119)
    static_regularization_enable: bool = True
    static_regularization_constant: float = 1e-8
    # plain python float: a np.float64 scalar here is a strong type that
    # silently promotes f32 factor buffers to f64 inside scatter-adds
    static_regularization_proportional: float = float(
        np.finfo(np.float64).eps ** 2
    )

    # dynamic regularization (reference: src/settings.jl:122-124)
    dynamic_regularization_enable: bool = True
    dynamic_regularization_eps: float = 1e-13
    dynamic_regularization_delta: float = 2e-7

    # iterative refinement (reference: src/settings.jl:127-132)
    iterative_refinement_enable: bool = True
    iterative_refinement_reltol: float = 1e-13
    iterative_refinement_abstol: float = 1e-12
    iterative_refinement_max_iter: int = 10
    iterative_refinement_stop_ratio: float = 5.0

    # preprocessing (reference: src/settings.jl:135-136)
    presolve_enable: bool = True
    input_sparse_dropzeros: bool = False

    # chordal decomposition (reference: src/settings.jl:139-142)
    chordal_decomposition_enable: bool = True
    chordal_decomposition_merge_method: str = "clique_graph"
    chordal_decomposition_compact: bool = True
    chordal_decomposition_complete_dual: bool = True

    # ---- TPU-native additions (no reference analogue) ----
    # trace/compile dtype of the solver core
    dtype: str = "float64"
    # factorization dtype; may be lower precision than `dtype`, with
    # iterative refinement recovering full accuracy (mixed-precision mode)
    factor_dtype: Optional[str] = None
    # bound on the barrier backtrack line search trip count inside jit
    # (reference uses a 50-iteration loop, src/solver.jl:432)
    linesearch_max_iter: int = 50
    # two-phase precision schedule: factor in f32 while mu > mu_switch,
    # then in factor_dtype; iterative refinement recovers full accuracy
    mixed_precision: bool = False
    mixed_precision_mu_switch: float = 1e-4
    # Pallas kernels for the batched factorization hot path
    # (None = auto: on for f32 factors on TPU backends)
    use_pallas: Optional[bool] = None
    # dense LDL applies via an explicit log-depth L⁻¹ (triangular solves
    # become matvecs; accuracy restored by refinement).  None = auto:
    # on for KKT dim <= 512 (the latency-bound regime)
    dense_solve_via_inverse: Optional[bool] = None
    # phase-resolved timers: route solve() through the staged pipeline
    # (prepare / IPM loop / finalize as separate dispatches with sync
    # points) so print_timers() can show a per-phase tree (the TPU
    # counterpart of the reference's TimerOutputs tree, src/types.jl:362).
    # Adds 2-3 dispatch boundaries per solve; off by default.
    timing: bool = False
    # KKT backend: "ldl" (augmented quasidefinite LDL), "condensed"
    # (normal equations + Cholesky, few large batched ops — fastest for
    # vmapped small instances), "blockarrow" (single-level structured
    # partition + Schur), "multifrontal" (multilevel nested-dissection,
    # level-synchronous vmapped fronts — for grid/mesh structure whose
    # single-level separator is large), or "auto" (structure-probing)
    kkt_backend: str = "auto"
    # sparse data mode: keep P/A in COO form end-to-end with map-based
    # block-arrow KKT assembly (None = auto: scipy-sparse inputs with
    # n+m > 2000 and a detectable block-arrow structure)
    sparse_data: Optional[bool] = None
    # dense-LDL elimination order: True sorts pivots by descending
    # |diag| at each factorization (quasidefinite-safe; prevents the
    # pivot growth that breaks the natural order on P=0 big-SOC
    # problems — kkt/dense.py), False keeps the reference's natural
    # [x-block; z-block] order, None = auto (on, except on the
    # lane-batched Pallas factor path which needs trace-time Dsigns).
    dense_ldl_diag_order: Optional[bool] = None
    # megakernel (ipm/megakernel.py) two-phase precision schedule: the
    # fused Pallas IPM runs plain-f32 iterations while mu >
    # megakernel_switch_mu, then double-float (f32-pair) endgame
    # iterations; all termination statuses are assigned by the
    # double-float phase, so certified accuracy is unchanged.  Default
    # OFF: measured on v5e, the f32 phase does not pay at 1e-8
    # tolerances — much of the loop body (step lengths, masks, norms)
    # is already f32 in the double-float kernel, and the cheaper f32
    # steps cost extra iterations (29.5 ms -> 44.3 ms per 4096-lane
    # batch at mu_switch=1e-3; docs/PERF.md round 3).  Kept as an
    # option for relaxed-tolerance workloads.
    megakernel_two_phase: bool = False
    megakernel_switch_mu: float = 1e-3
    # triple-float (f32-triple, ~2^-72) residual evaluation inside the
    # megakernel's double-float phase: the IPM rhs residuals and the
    # iterative-refinement residuals are accumulated with error-free
    # products (linalg/df64.TF), which removes the eps_df*kappa(K)
    # limiting-accuracy wall of refined solves — the mechanism behind
    # the round-4 "float-float ALMOST class" (docs/STATUS.md).  Costs
    # ~2-3x on the residual matvecs only; default on.
    megakernel_tf_residual: bool = True
    # stall detection at the accuracy floor.  The reference's
    # insufficient-progress check (src/info.jl:80-91) requires a strict
    # residual *increase* while the gap is already below tolerance; on
    # TPU, f64 is float-float emulation (~2^-49 unit roundoff) and lanes
    # pinned at that floor wander by fractions of an ulp for ~10 extra
    # iterations before the first uptick.  A residual improving by less
    # than (1 - ratio) per iteration is treated as not improving for the
    # purposes of that check (normal IPM steps contract residuals ~10x,
    # so this only fires on hopeless tails).  1.0 restores the exact
    # reference semantics.  See docs/DEVIATIONS.md #11.
    stall_detection_ratio: float = 0.99

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_dict(d: dict) -> "Settings":
        """reference: src/settings.jl:160-166 (settings_populate!)"""
        valid = {f.name for f in dataclasses.fields(Settings)}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"unknown settings: {sorted(unknown)}")
        return Settings(**d)

    @staticmethod
    def throughput(**overrides) -> "Settings":
        """Preset for maximum batched throughput: a full-float32 solve with
        tolerances at the float32 accuracy floor and float32-appropriate
        regularization, on the dense `ldl` backend (whose float32 factor
        is the LDL kernel K2 on the card).  Use when 1e-5-grade solutions
        suffice.  reference: clarabel_tpu/settings.py:195-216"""
        base = dict(
            dtype="float32",
            kkt_backend="ldl",
            tol_gap_abs=1e-5, tol_gap_rel=1e-5, tol_feas=1e-5,
            tol_infeas_abs=1e-5, tol_infeas_rel=1e-5,
            reduced_tol_gap_abs=1e-3, reduced_tol_gap_rel=1e-3,
            reduced_tol_feas=1e-3,
            static_regularization_constant=1e-6,
            dynamic_regularization_eps=1e-7,
            dynamic_regularization_delta=2e-5,
            iterative_refinement_abstol=1e-6,
            iterative_refinement_reltol=1e-6,
        )
        base.update(overrides)
        return Settings(**base)
