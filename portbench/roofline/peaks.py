"""The published peaks of one NVIDIA H100 SXM that the bounds divide by
(NVIDIA's data sheet, at its 700 W power limit; the run prints the card's
limit beside them)."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores, operations/s
HBM_BYTES = 3.35e12  # device memory, bytes/s


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the memory peak."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)


def real_fft_ops(n: int) -> float:
    """A windowed real n-point transform as a real FFT: 2.5 n log2 n, plus n
    window products."""
    import math

    return 2.5 * n * math.log2(n) + n
