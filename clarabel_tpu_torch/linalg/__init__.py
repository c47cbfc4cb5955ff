"""Batched dense linear algebra: small products, the LDL factor, and K2."""
