"""Work of the backward render kernel (``csrc/render_bwd.cu``): from the
cotangent of H, the gradients of the 7 per-path inputs.

Bytes: the cotangent planes [U, R*T, 2K] and the 7 per-path inputs [U, P]
read once, the 7 gradients [U, P] written once (float32). Operations: dE
= ct g and dg = ct^T E, 16 flops per (r, t, k) and valid path.
"""

KERNEL = "render_bwd_kernel"


def count(s: dict):
    """(bytes, flops) for the shapes ``s``: users, max_paths, valid_paths
    (the sum over users), rx, tx, k."""
    q = s["rx"] * s["tx"]
    n_bytes = 2 * 4 * 7 * s["users"] * s["max_paths"] + \
        4 * 2 * s["users"] * q * s["k"]
    return n_bytes, 16 * q * s["k"] * s["valid_paths"]
