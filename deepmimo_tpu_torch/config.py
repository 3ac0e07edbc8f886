"""Global configuration singleton of the PyTorch port.

Same interface as ``deepmimo_tpu.config`` (get/set, item access, callable
get/set, reset), holding the keys the port reads. ``device`` is new: the
torch device every tensor of the compute path is created on.

Usage::

    from deepmimo_tpu_torch import config
    config.set('device', 'cpu')
    config('scenarios_folder', '/data')
"""

from __future__ import annotations

from typing import Any, Optional

from . import consts as c


class DeepMIMOConfig:
    """Singleton holding global configuration parameters."""

    _instance: Optional["DeepMIMOConfig"] = None

    _DEFAULTS = {
        # Ray-tracer versions the converters write into rt_params
        "wireless_insite_version": c.RAYTRACER_VERSION_WIRELESS_INSITE,
        "sionna_version": c.RAYTRACER_VERSION_SIONNA,
        "aodt_version": c.RAYTRACER_VERSION_AODT,
        # Scenario storage
        "scenarios_folder": c.SCENARIOS_FOLDER,
        # Torch device of the compute path ("cuda", "cuda:1", "cpu", ...)
        "device": "cuda",
        "compute_dtype": "complex64",     # channel output dtype
        "render_backend": "fused",        # path-sum backend: fused|pallas|xla
        "planes_layout": "packed",        # H plane layout: packed|stacked
        # Precision of the fused kernels' products (ops/kernels/render.py
        # MM_PASSES): "float32" and "highest" = 3xTF32 on the tensor cores
        # (hi*hi + hi*lo + lo*hi, f32 grade) in the render kernels and the
        # path sum, FP32 FMA in the beam gain; "bfloat16" and "default" =
        # one pass on operands rounded to bf16, f32 accumulation (render
        # forward and backward, the beam gain's path sum; the path sum and
        # render_channels stay f32). Any other string raises ValueError.
        "matmul_dtype": "float32",
        # Planes-renderer output dtype: "float32" or "bfloat16" (half the
        # bytes of H, stored by the kernel; widened to complex64 on the
        # host)
        "planes_out_dtype": "float32",
        "user_block": 16384,              # users per block when streaming
        # Folder of the streamed render's checkpoint store
        # (generator/checkpoint.py): with it set, a host result streams
        # over user blocks, each saved once copied to the host, and a
        # render of the same inputs resumes from the blocks on disk.
        "checkpoint_dir": None,
        # compute_channels renders in ONE launch when the output tensor fits
        # this budget (bytes); larger outputs stream over user_block blocks
        # with the device->host copy overlapped against compute.
        "max_device_output_bytes": 6_000_000_000,
        # Host bytes Dataset.array_response_product may take (it is
        # O(users x antennas^2 x paths); above this it raises MemoryError
        # with guidance).
        "max_array_product_bytes": 4 << 30,
        # Dimension names of parallel.make_mesh's (users, tile) mesh
        "mesh_axis_users": "users",
        "mesh_axis_tile": "tile",
        # Scenario database (api.py: upload, download, search)
        "api_endpoint": "https://dev.deepmimo.net",
    }

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._data = dict(cls._DEFAULTS)
        return cls._instance

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def set(self, key: str, value: Any) -> None:
        if key not in self._data:
            raise KeyError(
                f"Unknown config key '{key}'. Valid keys: {sorted(self._data)}")
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __call__(self, key: Optional[str] = None, value: Any = None) -> Any:
        """config() prints; config(key) gets; config(key, value) sets."""
        if key is None:
            self.print_config()
            return None
        if value is None:
            return self.get(key)
        self.set(key, value)
        return None

    def reset(self) -> None:
        """Restore all settings to their defaults."""
        self._data = dict(self._DEFAULTS)

    def print_config(self) -> None:
        print("DeepMIMO-TPU (PyTorch port) configuration:")
        for k in sorted(self._data):
            print(f"  {k}: {self._data[k]}")

    def __repr__(self) -> str:
        return f"DeepMIMOConfig({self._data})"


config = DeepMIMOConfig()
