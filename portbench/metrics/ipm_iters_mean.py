"""Mean of `BatchSolution.iterations` over every lane of every call of the
window."""


def read(run):
    return run.iterations / run.lanes if run.lanes else None
