"""SOLVED lanes of every call in the window over the window's seconds."""


def read(run):
    return run.solved / run.window_s
