"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W), and the least time a kernel's work could take on it.

Operations are counted at the f32 grade the port's kernels compute at: the
fastest f32-grade route the card offers is three TF32 passes on the tensor
cores (hi*hi + hi*lo + lo*hi), so an f32-grade flop costs ``TF32_PASSES``
TF32 flops.
"""

HBM_BYTES_PER_S = 3.35e12      # HBM3
TF32_FLOPS_PER_S = 495e12      # dense TF32, tensor cores
TF32_PASSES = 3


def bound_s(n_bytes: float, flops: float):
    """(least seconds, "bytes" or "operations": which sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = TF32_PASSES * flops / TF32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
