"""The interior-point solver: the batched megakernel and its plain version,
and the batched IPM loop solver."""
