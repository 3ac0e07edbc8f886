"""Work of the beam-gain kernel (``csrc/beamgain.cu``): G = |conj(W) H|^2
without H.

Bytes: the 7 per-path inputs [U, P] and the codebook [T, B] (complex,
float32) read once, G [U, R*B, K] (float32) written once. Operations, per
valid path: the fold eb = conj(W) a_tx (8 flops per (b, t)), the path sum
(8 flops per (r, b, k)); per output the power |y|^2 (3 flops).
"""

KERNEL = "beamgain_kernel"


def count(s: dict):
    """(bytes, flops) for the shapes ``s``: users, max_paths, valid_paths
    (the sum over users), rx, tx, k, beams."""
    r, t, k, b = s["rx"], s["tx"], s["k"], s["beams"]
    n_bytes = 4 * 7 * s["users"] * s["max_paths"] + 4 * 2 * b * t + \
        4 * s["users"] * r * b * k
    flops = 8 * b * t * s["valid_paths"] + 8 * r * b * k * s["valid_paths"] \
        + 3 * s["users"] * r * b * k
    return n_bytes, flops
