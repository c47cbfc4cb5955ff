"""Which of the program's device kernels a traced window's kernel names
belong to, in one place for every per-layer reader: K1, the megakernel
(`mk_kernel` of csrc/megakernel.cu and csrc/megakernel_group.cu), and K2,
the LDL-inverse kernels (`ldl_rows_kernel` of csrc/ldl_inverse_rows.cu,
`ldl_rows_wide_kernel` of csrc/ldl_inverse_rows_wide.cu, `ldl_inv_kernel`
of csrc/ldl_inverse.cu).  Every other kernel is one of the loop solver's
torch operations."""

K1_NAMES = ("mk_kernel",)
K2_NAMES = ("ldl_rows_kernel", "ldl_rows_wide_kernel", "ldl_inv_kernel")


def is_k1(name):
    return any(k in name for k in K1_NAMES)


def is_k2(name):
    return any(k in name for k in K2_NAMES)


def is_loop_op(name):
    return not is_k1(name) and not is_k2(name)
