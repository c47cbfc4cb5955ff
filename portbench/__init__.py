"""The benchmark of the PyTorch / CUDA port (`clarabel_tpu_torch`).

`run.py` runs one cell once; `harness.py` says what a run does and where
each cell's, configuration's and metric's files sit.  Nothing here imports
the JAX package or JAX, and the reference (`references/`) imports nothing
of the port.
"""
