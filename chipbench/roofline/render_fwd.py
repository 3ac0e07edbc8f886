"""Work of the forward render kernel (``csrc/render_fwd.cu``): H = E g^T
per user.

Bytes: its 7 per-path inputs [U, P] (float32: gry, grz, gty, gtz, amp, psi,
omega) read once, and the planes of H [U, R*T, 2K] (float32) written once.
Operations: 8 flops per complex multiply-add, one per (r, t, k) and valid
path: the paths these inputs hold, not the padded P.
"""

KERNEL = "render_fwd_kernel"


def count(s: dict):
    """(bytes, flops) for the shapes ``s``: users, max_paths, valid_paths
    (the sum over users), rx, tx, k."""
    q = s["rx"] * s["tx"]
    n_bytes = 4 * 7 * s["users"] * s["max_paths"] + \
        4 * 2 * s["users"] * q * s["k"]
    return n_bytes, 8 * q * s["k"] * s["valid_paths"]
