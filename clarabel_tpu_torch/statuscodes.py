"""Solver status codes.

Mirrors the 11-value SolverStatus enum of the reference implementation
(reference: src/statuscodes.jl:24-68).  The values are the reference's, so
that the kernel can write them as int32 and both packages read them alike.
"""

import enum


class SolverStatus(enum.IntEnum):
    UNSOLVED = 0
    SOLVED = 1
    PRIMAL_INFEASIBLE = 2
    DUAL_INFEASIBLE = 3
    ALMOST_SOLVED = 4
    ALMOST_PRIMAL_INFEASIBLE = 5
    ALMOST_DUAL_INFEASIBLE = 6
    MAX_ITERATIONS = 7
    MAX_TIME = 8
    NUMERICAL_ERROR = 9
    INSUFFICIENT_PROGRESS = 10


_STATUS_STRINGS = {
    SolverStatus.UNSOLVED: "unsolved",
    SolverStatus.SOLVED: "solved",
    SolverStatus.PRIMAL_INFEASIBLE: "primal infeasible",
    SolverStatus.DUAL_INFEASIBLE: "dual infeasible",
    SolverStatus.ALMOST_SOLVED: "solved (reduced accuracy)",
    SolverStatus.ALMOST_PRIMAL_INFEASIBLE: "primal infeasible (reduced accuracy)",
    SolverStatus.ALMOST_DUAL_INFEASIBLE: "dual infeasible (reduced accuracy)",
    SolverStatus.MAX_ITERATIONS: "iteration limit",
    SolverStatus.MAX_TIME: "time limit",
    SolverStatus.NUMERICAL_ERROR: "numerical error",
    SolverStatus.INSUFFICIENT_PROGRESS: "insufficient progress",
}


def status_string(status: SolverStatus) -> str:
    return _STATUS_STRINGS[SolverStatus(int(status))]


def status_is_infeasible(status) -> bool:
    """reference: src/statuscodes.jl:52-59"""
    s = SolverStatus(int(status))
    return s in (
        SolverStatus.PRIMAL_INFEASIBLE,
        SolverStatus.DUAL_INFEASIBLE,
        SolverStatus.ALMOST_PRIMAL_INFEASIBLE,
        SolverStatus.ALMOST_DUAL_INFEASIBLE,
    )


def status_is_errored(status) -> bool:
    """reference: src/statuscodes.jl:61-68"""
    s = SolverStatus(int(status))
    return s in (SolverStatus.NUMERICAL_ERROR, SolverStatus.INSUFFICIENT_PROGRESS)
