"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit): every roofline share and ``mfu`` of the
benchmark is stated against them, with the card's power limit reported
beside it."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops, nbytes):
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
