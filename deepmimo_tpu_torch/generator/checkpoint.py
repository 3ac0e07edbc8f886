"""Checkpoint/resume of the streamed render.

Each user block that ``compute_channels`` streams to the host is saved as
an .npy file under a fingerprint of the render's inputs, so an interrupted
render resumes at the first missing block, and chunks of another dataset
or configuration are never mixed in. Counterpart of
``deepmimo_tpu/generator/checkpoint.py``; the fingerprint here covers the
data (per-path matrices, panel rotations, polarization matrices) as well
as the configuration, the user count and the block size, and a block is
one uncompressed array in its own dtype (complex128 resumes bit for bit;
no zip container, whose CRC costs as much as the disk).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch


class ChunkStore:
    """On-disk store of rendered channel blocks for one render's inputs.

    Layout: ``<root>/<fingerprint>/block_<start>.npy`` + manifest.json.
    """

    def __init__(self, root: str, fingerprint: str):
        self.dir = os.path.join(root, fingerprint)
        os.makedirs(self.dir, exist_ok=True)
        self._manifest_path = os.path.join(self.dir, "manifest.json")

    @staticmethod
    def fingerprint(cfg, n_ue: int, block: int, tensors,
                    extra: dict | None = None) -> str:
        """SHA-256 (first 16 hex digits) of the configuration, the user
        count, the block size and the host bytes of ``tensors`` (None
        entries skipped), each with its dtype and shape."""
        h = hashlib.sha256(json.dumps(
            {"cfg": repr(cfg), "n_ue": n_ue, "block": block,
             "extra": extra or {}}, sort_keys=True).encode())
        for t in tensors:
            if t is None:
                continue
            a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
                else np.asarray(t)
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        return h.hexdigest()[:16]

    def has_block(self, start: int) -> bool:
        return os.path.exists(self._block_path(start))

    def _block_path(self, start: int) -> str:
        return os.path.join(self.dir, f"block_{start:09d}.npy")

    def save_block(self, start: int, channel: np.ndarray) -> None:
        """Write one block atomically (a temp file, then a rename)."""
        tmp = self._block_path(start) + ".tmp"
        with open(tmp, "wb") as f:
            # one contiguous write: np.save writes a strided array (the
            # polarization axis moved first) in 512-byte pieces
            np.save(f, np.ascontiguousarray(channel))
        os.replace(tmp, self._block_path(start))

    def load_block(self, start: int) -> np.ndarray:
        return np.load(self._block_path(start))

    def write_manifest(self, meta: dict) -> None:
        with open(self._manifest_path, "w") as f:
            json.dump(meta, f, indent=1)

    def blocks(self):
        return sorted(int(f[6:15]) for f in os.listdir(self.dir)
                      if f.startswith("block_") and f.endswith(".npy"))
