"""Data types of the PyTorch channel renderer.

``PathData`` is the device-resident struct-of-arrays view of one TX-RX
pair's ray data, converted to masks + fill values so every tensor is
NaN-free. ``AntennaPanel`` holds one side's rotation and spacing.
``ChannelConfig`` is the static, hashable part of the channel-generation
parameters (shapes, pattern names, subcarrier selection). Counterparts of
``deepmimo_tpu/ops/types.py``; frozen dataclasses of tensors replace the
JAX pytrees, and every constructor takes an explicit ``device``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.profiling import span


def _device(device) -> torch.device:
    if device is None:
        from ..config import config
        device = config.get("device")
    return torch.device(device)


def _small_tensor(x, dtype, dev: torch.device) -> torch.Tensor:
    """A small host value on ``dev`` without stalling the host: a copy from
    pageable memory waits for the stream's queued kernels, so a CUDA copy
    goes through pinned memory and is not waited for."""
    t = torch.as_tensor(np.asarray(x, np.float64), dtype=dtype)
    if dev.type == "cuda":
        with span("dm.h2d"):
            return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


@dataclasses.dataclass(frozen=True)
class PathData:
    """Struct-of-arrays per-path ray data for U users x P paths (padded).

    Angle fields are in DEGREES (scenario-format convention); power in dBW.
    ``valid`` marks real paths; padded slots hold zeros and must be masked.
    Doppler fields are optional (None when the scenario has no mobility).
    """

    power_dbw: torch.Tensor          # [U, P] path power, dBW
    phase_deg: torch.Tensor          # [U, P] path phase, degrees
    delay_s: torch.Tensor            # [U, P] time of arrival, seconds
    aoa_az_deg: torch.Tensor         # [U, P]
    aoa_el_deg: torch.Tensor         # [U, P]
    aod_az_deg: torch.Tensor         # [U, P]
    aod_el_deg: torch.Tensor         # [U, P]
    valid: torch.Tensor              # [U, P] bool
    doppler_vel: Optional[torch.Tensor] = None   # [U, P] radial m/s
    doppler_acc: Optional[torch.Tensor] = None   # [U, P] radial m/s^2

    @property
    def n_ue(self) -> int:
        return self.power_dbw.shape[0]

    @property
    def max_paths(self) -> int:
        return self.power_dbw.shape[1]

    @classmethod
    def from_numpy(cls, power, phase, delay, aoa_az, aoa_el, aod_az, aod_el,
                   doppler_vel=None, doppler_acc=None, dtype=torch.float32,
                   device=None) -> "PathData":
        """Build from NaN-padded numpy matrices (the on-disk convention)."""
        dev = _device(device)
        power = np.asarray(power)
        valid = ~np.isnan(power)

        def clean(x):
            x = np.where(valid, np.nan_to_num(np.asarray(x, np.float64)), 0.0)
            return torch.as_tensor(x, dtype=dtype, device=dev)

        # A dm.h2d span where the arrays go to a card.
        with span("dm.h2d") if dev.type == "cuda" else \
                contextlib.nullcontext():
            return cls(
                power_dbw=clean(power),
                phase_deg=clean(phase),
                delay_s=clean(delay),
                aoa_az_deg=clean(aoa_az),
                aoa_el_deg=clean(aoa_el),
                aod_az_deg=clean(aod_az),
                aod_el_deg=clean(aod_el),
                valid=torch.as_tensor(valid, device=dev),
                doppler_vel=None if doppler_vel is None
                else clean(doppler_vel),
                doppler_acc=None if doppler_acc is None
                else clean(doppler_acc),
            )

    def _map(self, fn) -> "PathData":
        return PathData(**{f.name: None if getattr(self, f.name) is None
                           else fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})

    def slice_users(self, start: int, size: int) -> "PathData":
        """Users [start, start + size) (views, no copy)."""
        return self._map(lambda x: x[start:start + size])

    def trim_paths(self, num_paths: int) -> "PathData":
        """Keep only the first ``num_paths`` path slots."""
        return self._map(lambda x: x[:, :num_paths])


@dataclasses.dataclass(frozen=True)
class AntennaPanel:
    """Antenna-array parameters for one side (TX or RX).

    ``rotation_deg`` is [3] (one rotation for all users) or [U, 3]
    (per-user rotations); ``spacing`` is a scalar tensor in wavelengths.
    The panel shape itself is static and lives in ChannelConfig.
    """

    rotation_deg: torch.Tensor       # [3] or [U, 3]
    spacing: torch.Tensor            # scalar, wavelengths

    @classmethod
    def make(cls, rotation_deg=(0.0, 0.0, 0.0), spacing=0.5,
             dtype=torch.float32, device=None) -> "AntennaPanel":
        dev = _device(device)
        return cls(rotation_deg=_small_tensor(rotation_deg, dtype, dev),
                   spacing=_small_tensor(float(spacing), dtype, dev))


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Static channel-generation configuration (hashable).

    Same fields and defaults as ``deepmimo_tpu.ops.types.ChannelConfig``
    except the TPU kernel-layout flags, which have no counterpart here.
    """

    bs_shape: Tuple[int, int] = (8, 1)
    ue_shape: Tuple[int, int] = (1, 1)
    bs_pattern: str = "isotropic"
    ue_pattern: str = "isotropic"
    freq_domain: bool = True
    # OFDM
    subcarriers: int = 512
    selected_subcarriers: Tuple[int, ...] = (0,)
    bandwidth: float = 10e6
    rx_filter: bool = False            # sinc low-pass filter
    # Paths
    num_paths: int = 25
    # FoV (degrees); None disables filtering for that side
    bs_fov: Optional[Tuple[float, float]] = None
    ue_fov: Optional[Tuple[float, float]] = None
    # Doppler
    enable_doppler: bool = False
    carrier_freq: float = 3.5e9
    doppler_times: Tuple[float, ...] = (0.0,)
    # Time-domain path compaction (valid paths packed to the front of the
    # path axis, as the reference orders them). "auto" compacts only when
    # an FoV filter is active: loaded path data is tail-padded, so only
    # the FoV punches interior holes. True always compacts (hand-built
    # path data with interior holes); False never.
    compact_td_paths: Union[bool, str] = "auto"
    # Precision of the complex output
    dtype: str = "complex64"
    # Product precision of the fused kernels (config.py "matmul_dtype"):
    # "float32"/"highest" f32 grade, "bfloat16"/"default" one bf16 pass
    matmul_dtype: str = "float32"
    # Path-sum backend: "xla" (eager planes einsum) or "fused"/"pallas"
    # (the hand-written render kernel)
    backend: str = "xla"
    # Plane layout of render_channels_planes: "stacked" -> [2, U, R, T, K];
    # "packed" -> [U, R, T, 2K] with hr in the first minor half (used
    # when S*K % 64 == 0, else stacked).
    planes_layout: str = "stacked"
    # Output precision of the planes renderers: "float32" or "bfloat16"
    out_dtype: str = "float32"

    @property
    def n_rx_ant(self) -> int:
        return int(np.prod(self.ue_shape))

    @property
    def n_tx_ant(self) -> int:
        return int(np.prod(self.bs_shape))

    @property
    def n_sel_subcarriers(self) -> int:
        return len(self.selected_subcarriers)

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex64 if self.dtype == "complex64" else \
            torch.complex128

    @property
    def rdtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "complex64" else torch.float64

    def replace(self, **kw) -> "ChannelConfig":
        return dataclasses.replace(self, **kw)


def _tensor_from_numpy(x, dev: torch.device,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = np.array(x)                      # owned, writable copy
    return torch.as_tensor(x, device=dev, dtype=torch.bool
                           if x.dtype == np.bool_ else dtype)


def state_from_numpy(paths: dict, bs: dict, ue: dict, cfg: dict,
                     device=None):
    """(PathData, bs AntennaPanel, ue AntennaPanel, ChannelConfig) from
    plain numpy arrays and dicts.

    ``paths`` maps PathData field names to arrays (``valid`` bool, the
    rest already zero-filled) or None; ``bs``/``ue`` map ``rotation_deg``
    and ``spacing``; ``cfg`` maps ChannelConfig field names to values —
    keys the port has no field for (TPU layout flags) are dropped. The
    float tensors are float64 for a complex128 ``cfg``, else float32.
    """
    dev = _device(device)
    dtype = torch.float64 if cfg.get("dtype") == "complex128" else \
        torch.float32
    tensor = lambda x: _tensor_from_numpy(x, dev, dtype)
    pd = PathData(**{f.name: None if paths.get(f.name) is None
                     else tensor(paths[f.name])
                     for f in dataclasses.fields(PathData)})
    panels = [AntennaPanel(rotation_deg=tensor(p["rotation_deg"]),
                           spacing=tensor(p["spacing"])) for p in (bs, ue)]
    names = {f.name for f in dataclasses.fields(ChannelConfig)}
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.items() if k in names}
    return pd, panels[0], panels[1], ChannelConfig(**fields)


def calib_params_from_numpy(params: dict, device=None):
    """The port's ``parallel.CalibParams`` from plain numpy leaves.

    ``params`` maps the CalibParams field names to arrays, with ``bs`` and
    ``ue`` as dicts of ``rotation_deg`` and ``spacing`` (a JAX
    ``CalibParams._asdict()`` with its panels turned into dicts).
    """
    from ..parallel.sharded import CalibParams
    dev = _device(device)
    kw = {k: _tensor_from_numpy(v, dev) for k, v in params.items()
          if k not in ("bs", "ue")}
    panels = {k: AntennaPanel(
        rotation_deg=_tensor_from_numpy(params[k]["rotation_deg"], dev),
        spacing=_tensor_from_numpy(params[k]["spacing"], dev))
        for k in ("bs", "ue")}
    return CalibParams(**panels, **kw)
