"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time of a kernel's work."""

PEAK_BYTES_S = 3.35e12      # HBM3
PEAK_F32_S = 67e12          # float32 outside the tensor cores, FMA = 2


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    the float32 rate."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)
