from .decomp import ChordalInfo, try_chordal_decomposition
