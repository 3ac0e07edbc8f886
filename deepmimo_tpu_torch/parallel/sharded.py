"""Sharded channel rendering and distributed differentiable calibration.

Counterpart of ``deepmimo_tpu/parallel/sharded.py``, on a (users, tile)
mesh of process ranks (``parallel/mesh.py``), one device per rank:

- ``render_channels_sharded`` and its siblings: each rank renders its own
  block of users with the single-device entry points of ``ops/channel.py``
  (so the CUDA kernels run), cut to its tile rank's slice of the last
  axis, and wraps it as a DTensor in the layout that the JAX package's
  ``with_sharding_constraint`` names: users over the users axis, the last
  axis over the tile axis. ``.full_tensor()`` is the global array and
  ``.to_local()`` this rank's shard. A tile rank renders only its own
  subcarriers or snapshots where its slice is exactly those (the
  single-pol channels, and the beam gains of one snapshot); elsewhere it
  renders its users whole and keeps its slice.

- ``training_step`` / ``training_step_planes``: one step of
  gradient-based calibration of the array geometry and of per-path
  corrections to the ray parameters against target channels, with plain
  SGD, on one device. With ``cfg.backend`` "fused",
  :func:`training_step_planes` runs the fused render's forward and
  backward CUDA kernels; :func:`training_step` with "pallas" runs the
  path-sum kernel. :func:`make_sharded_training_step` runs the complex
  loss on a mesh: the loss and the panel gradients are all-reduced over
  the whole mesh, per-user gradients over the tile axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.channel import (render_beam_gains, render_beam_gains_polar,
                           render_channels, render_channels_planes,
                           render_channels_planes_polar)
from ..ops.types import AntennaPanel, ChannelConfig, PathData
from ..utils.profiling import span
from .mesh import (DTensor, DeviceMesh, Replicate, Shard, block,
                   channel_sharding, replicated, user_sharding)


# ============================================================================
# Sharded renders
# ============================================================================

def _stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _wrap(local: torch.Tensor, mesh: DeviceMesh, placements,
          shape) -> DTensor:
    """This rank's block as a DTensor of global ``shape``."""
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))


def _user_rows(n_ue: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """[start, end) of this rank's users: its users-axis coordinate's
    block. The users must divide evenly over the axis, as the JAX
    package's user sharding requires."""
    n_u = mesh.size(0)
    if n_ue % n_u:
        raise ValueError(f"{n_ue} users do not divide evenly over the "
                         f"mesh's users axis of size {n_u}")
    return block(n_ue, n_u, mesh.get_coordinate()[0])


def _block_of(x: torch.Tensor, mesh: DeviceMesh, placements
              ) -> torch.Tensor:
    """This rank's block of a plain tensor holding the global value (the
    same on every rank)."""
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            if dim == 0:
                a, b = _user_rows(x.shape[p.dim], mesh)
            else:
                a, b = block(x.shape[p.dim], mesh.size(dim),
                             mesh.get_coordinate()[dim])
            x = x.narrow(p.dim, a, b - a)
    return x


def _place(x, mesh: DeviceMesh, placements):
    """``x`` as a DTensor in ``placements``: a plain tensor is cut to this
    rank's block (:func:`_block_of`); a DTensor is redistributed where its
    placements differ."""
    if x is None:
        return None
    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(placements) and \
                x.device_mesh == mesh:
            return x
        return x.redistribute(mesh, placements)
    return _wrap(_block_of(x, mesh, placements), mesh, placements, x.shape)


def _local_block(x, mesh: DeviceMesh, placements):
    """This rank's block of ``x`` in ``placements`` as a plain tensor (no
    DTensor is made for a plain ``x``)."""
    if isinstance(x, DTensor):
        return _place(x, mesh, placements).to_local()
    return _block_of(x, mesh, placements)


def shard_paths(paths: PathData, mesh: DeviceMesh) -> PathData:
    """PathData with every leaf a DTensor sharded on its user axis."""
    return paths._map(lambda x: _place(x, mesh, user_sharding(mesh)))


def _rows(x, u0: int, u1: int):
    """A panel leaf on this rank: a user-sharded DTensor's block, a
    replicated per-user [U, 3] rotation cut to the rank's users, a [3]
    rotation or a spacing as it is."""
    if isinstance(x, DTensor):
        if isinstance(x.placements[0], Shard):
            return x.to_local()
        x = x.to_local()
    return x[u0:u1] if x.ndim == 2 else x


def _local_state(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                 mesh: DeviceMesh):
    """(this rank's users' PathData, bs, ue, the global user count)."""
    n_ue = paths.power_dbw.shape[0]
    u0, u1 = _user_rows(n_ue, mesh)
    panels = [AntennaPanel(_rows(p.rotation_deg, u0, u1),
                           _rows(p.spacing, u0, u1)) for p in (bs, ue)]
    lpaths = paths._map(lambda x: _local_block(x, mesh,
                                               user_sharding(mesh)))
    return lpaths, *panels, n_ue


def _tile_block(render: Callable, cfg: ChannelConfig, mesh: DeviceMesh,
                field: Optional[str] = None):
    """(``render(cfg)`` cut to this tile rank's block of its last axis, the
    axis's global length). With ``field`` ("selected_subcarriers" or
    "doppler_times"), the entries of that config field are the last axis,
    and a rank with a non-empty block renders only its own entries."""
    n_t, c_t = mesh.size(1), mesh.get_coordinate()[1]
    if field is not None:
        full = tuple(getattr(cfg, field))
        a, b = block(len(full), n_t, c_t)
        if b > a:
            h = render(cfg.replace(**{field: full[a:b]}))
            if field == "doppler_times" and b - a == 1:
                h = h.unsqueeze(-1)      # one snapshot has no time axis
            return h, len(full)
    h = render(cfg)
    a, b = block(h.shape[-1], n_t, c_t)
    return h[..., a:b], h.shape[-1]


def _channel_field(cfg: ChannelConfig) -> Optional[str]:
    """The config field whose entries are ``render_channels``' last axis:
    the snapshots of a multi-snapshot Doppler render, else the selected
    subcarriers of an unfiltered frequency-domain render (the time
    domain's last axis is the paths, the filter's full band an FFT)."""
    if cfg.enable_doppler and len(cfg.doppler_times) > 1:
        return "doppler_times"
    if cfg.freq_domain and not cfg.rx_filter:
        return "selected_subcarriers"
    return None


def _gain_field(cfg: ChannelConfig) -> Optional[str]:
    """Beam gains' last axis is S*K, snapshot-major: the subcarriers when
    there is one snapshot."""
    one = not cfg.enable_doppler or len(cfg.doppler_times) == 1
    return "selected_subcarriers" if one else None


def _sharded(local: torch.Tensor, n_last: int, n_ue: int, users_dim: int,
             mesh: DeviceMesh) -> DTensor:
    """This rank's block with users on ``users_dim`` over the users axis
    and the last axis over the tile axis."""
    shape = list(local.shape)
    shape[users_dim], shape[-1] = n_ue, n_last
    return _wrap(local, mesh, (Shard(users_dim), Shard(local.ndim - 1)),
                 shape)


def _pol_block(x, paths: PathData, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's users of a [N_pol, U, P] polarization stack."""
    if not isinstance(x, DTensor):
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=paths.valid.device)
    return _local_block(x, mesh, (Shard(1), Replicate()))


def render_channels_sharded(paths: PathData, bs: AntennaPanel,
                            ue: AntennaPanel, cfg: ChannelConfig,
                            mesh: DeviceMesh) -> DTensor:
    """Render channels with users sharded across the mesh.

    The per-user computation is independent, so each rank renders its
    block with :func:`render_channels` and no collective runs; the last
    axis (subcarriers, snapshots of a Doppler render, paths of the time
    domain) shards over the tile axis. Returns a DTensor of the global
    ``render_channels`` shape.
    """
    lpaths, lbs, lue, n_ue = _local_state(paths, bs, ue, mesh)
    h, n_last = _tile_block(
        lambda c: render_channels(lpaths, lbs, lue, c), cfg, mesh,
        _channel_field(cfg))
    return _sharded(h, n_last, n_ue, 0, mesh)


def render_polar_sharded(paths: PathData, bs: AntennaPanel,
                         ue: AntennaPanel, cfg: ChannelConfig,
                         pol_power_dbw, pol_phase_deg,
                         mesh: DeviceMesh) -> DTensor:
    """All four polarizations, one fused launch per rank, users sharded.

    The [N_pol, U, P] polarization stacks shard on their user axis
    alongside PathData. Returns the raw kernel-layout planes of
    :func:`render_channels_planes_polar` (packed [U, R, T, 2*N_pol*S*K],
    users on axis 0, or stacked [2, U, R, T, N_pol, S, K], users on axis
    1), the folded minor axis over the tile axis: in the packed layout hr
    fills its first half, so a tile rank's slice need not be whole
    channels, and each rank renders its users whole.
    """
    lpaths, lbs, lue, n_ue = _local_state(paths, bs, ue, mesh)
    pol_p = _pol_block(pol_power_dbw, lpaths, mesh)
    pol_ph = _pol_block(pol_phase_deg, lpaths, mesh)
    h, n_last = _tile_block(
        lambda c: render_channels_planes_polar(lpaths, lbs, lue, c, pol_p,
                                               pol_ph), cfg, mesh)
    return _sharded(h, n_last, n_ue, 0 if h.ndim == 4 else 1, mesh)


def render_beam_gains_sharded(paths: PathData, bs: AntennaPanel,
                              ue: AntennaPanel, cfg: ChannelConfig,
                              wr, wi, mesh: DeviceMesh) -> DTensor:
    """Beam-gain maps G [U, R*B, S*K] with users sharded across the mesh.

    Each rank folds the codebook into its users' path sum
    (:func:`render_beam_gains`, the beam-gain kernel on the card; H is
    never formed); the [B, T] codebook planes replicate. The S*K axis
    shards over the tile axis.
    """
    lpaths, lbs, lue, n_ue = _local_state(paths, bs, ue, mesh)
    g, n_last = _tile_block(
        lambda c: render_beam_gains(lpaths, lbs, lue, c, wr, wi), cfg,
        mesh, _gain_field(cfg))
    return _sharded(g, n_last, n_ue, 0, mesh)


def render_beam_gains_polar_sharded(paths: PathData, bs: AntennaPanel,
                                    ue: AntennaPanel, cfg: ChannelConfig,
                                    pol_power_dbw, pol_phase_deg,
                                    wr, wi, mesh: DeviceMesh) -> DTensor:
    """Dual-polar beam-gain maps G [U, R*B, N_pol*S*K] (one launch per
    rank, no H) with users sharded; the polarization stacks shard on their
    user axis, the codebook planes replicate, the folded pol-major minor
    axis shards over the tile axis (each rank renders its users whole)."""
    lpaths, lbs, lue, n_ue = _local_state(paths, bs, ue, mesh)
    pol_p = _pol_block(pol_power_dbw, lpaths, mesh)
    pol_ph = _pol_block(pol_phase_deg, lpaths, mesh)
    g, n_last = _tile_block(
        lambda c: render_beam_gains_polar(lpaths, lbs, lue, c, pol_p,
                                          pol_ph, wr, wi), cfg, mesh)
    return _sharded(g, n_last, n_ue, 0, mesh)


# ============================================================================
# Distributed differentiable calibration (the "training step")
# ============================================================================

@dataclasses.dataclass(frozen=True)
class CalibParams:
    """Learnable parameters of the channel model: panel geometry (shared
    across users) plus per-path corrections to the ray parameters."""

    bs: AntennaPanel
    ue: AntennaPanel
    d_power_dbw: torch.Tensor     # [U, P]
    d_phase_deg: torch.Tensor     # [U, P]
    d_delay_ns: torch.Tensor      # [U, P] (nanoseconds, for conditioning)
    d_angles_deg: torch.Tensor    # [U, P, 4]: aoa_az, aoa_el, aod_az, aod_el

    def leaves(self) -> List[torch.Tensor]:
        """The 8 tensors, panels first, in a fixed order."""
        return [self.bs.rotation_deg, self.bs.spacing, self.ue.rotation_deg,
                self.ue.spacing, self.d_power_dbw, self.d_phase_deg,
                self.d_delay_ns, self.d_angles_deg]

    @classmethod
    def from_leaves(cls, leaves) -> "CalibParams":
        bs_rot, bs_sp, ue_rot, ue_sp, *rest = leaves
        return cls(AntennaPanel(bs_rot, bs_sp), AntennaPanel(ue_rot, ue_sp),
                   *rest)


def init_calib_params(paths: PathData, bs: AntennaPanel,
                      ue: AntennaPanel) -> CalibParams:
    z = torch.zeros_like(paths.power_dbw)
    return CalibParams(bs=bs, ue=ue, d_power_dbw=z, d_phase_deg=z,
                       d_delay_ns=z,
                       d_angles_deg=torch.zeros(z.shape + (4,),
                                                dtype=z.dtype,
                                                device=z.device))


def _apply_calib(paths: PathData, params: CalibParams) -> PathData:
    da = params.d_angles_deg
    return PathData(
        power_dbw=paths.power_dbw + params.d_power_dbw,
        phase_deg=paths.phase_deg + params.d_phase_deg,
        delay_s=paths.delay_s + params.d_delay_ns * 1e-9,
        aoa_az_deg=paths.aoa_az_deg + da[..., 0],
        aoa_el_deg=paths.aoa_el_deg + da[..., 1],
        aod_az_deg=paths.aod_az_deg + da[..., 2],
        aod_el_deg=paths.aod_el_deg + da[..., 3],
        valid=paths.valid,
        doppler_vel=paths.doppler_vel,
        doppler_acc=paths.doppler_acc,
    )


def calib_loss(params: CalibParams, paths: PathData, target: torch.Tensor,
               cfg: ChannelConfig) -> torch.Tensor:
    """Normalized mean squared complex error vs the target channels.

    ``(err * conj(err)).real`` and not ``abs(err)**2``: the gradient of
    ``abs`` at 0 is NaN.
    """
    h = render_channels(_apply_calib(paths, params), params.bs, params.ue,
                        cfg)
    with span("dm.calib.loss"):
        err = h - target
        num = torch.mean((err * err.conj()).real)
        den = torch.mean((target * target.conj()).real) + 1e-30
        return num / den


def calib_loss_planes(params: CalibParams, paths: PathData,
                      target: torch.Tensor, cfg: ChannelConfig
                      ) -> torch.Tensor:
    """Planes-layout calibration loss (normalized MSE on real planes).

    Same objective as :func:`calib_loss` through
    :func:`render_channels_planes`; ``target`` is in the planes layout the
    cfg selects (stacked or packed). The error is one ``mse_loss`` (one
    fused elementwise kernel forward and one backward), where
    ``mean((h - target)**2)`` spends separate passes on the difference,
    the square and their backward. The target's power is the mean squared
    norm of the minor-axis rows: one read of the planes and no
    planes-sized temporary. (Not one ``vector_norm`` or ``dot`` over the
    whole tensor: on the CPU they sum float32 with too few partial sums
    and drift by 1e-5 to 1e-3 relative at tens of millions of elements;
    rows of a few hundred elements do not.)
    """
    h = render_channels_planes(_apply_calib(paths, params), params.bs,
                               params.ue, cfg)
    with span("dm.calib.loss"):
        den = torch.linalg.vector_norm(target, dim=-1).square().mean() / \
            target.shape[-1]
        return torch.nn.functional.mse_loss(h, target) / (den + 1e-30)


def calib_value_and_grad(loss_fn: Callable, params: CalibParams,
                         paths: PathData, target: torch.Tensor,
                         cfg: ChannelConfig
                         ) -> Tuple[torch.Tensor, CalibParams]:
    """(loss, gradients) of ``loss_fn(params, paths, target, cfg)`` with
    respect to every leaf of ``params``; None for a leaf the loss does not
    reach."""
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    with torch.enable_grad():
        with span("dm.calib.forward"):
            loss = loss_fn(CalibParams.from_leaves(leaves), paths, target,
                           cfg)
        with span("dm.calib.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), CalibParams.from_leaves(grads)


def _sgd_step(loss_fn, params, paths, target, cfg, lr):
    loss, grads = calib_value_and_grad(loss_fn, params, paths, target, cfg)
    with span("dm.calib.update"):
        new = [p if g is None else p.detach() - lr * g
               for p, g in zip(params.leaves(), grads.leaves())]
    return CalibParams.from_leaves(new), loss


def training_step_planes(params: CalibParams, paths: PathData,
                         target: torch.Tensor, cfg: ChannelConfig,
                         lr: float = 1e-3) -> Tuple[CalibParams,
                                                    torch.Tensor]:
    """One SGD calibration step on the planes path (fused fwd + bwd)."""
    return _sgd_step(calib_loss_planes, params, paths, target, cfg, lr)


def training_step(params: CalibParams, paths: PathData,
                  target: torch.Tensor, cfg: ChannelConfig,
                  lr: float = 1e-3) -> Tuple[CalibParams, torch.Tensor]:
    """One SGD step of channel-model calibration (complex loss)."""
    return _sgd_step(calib_loss, params, paths, target, cfg, lr)


def _sq_err_sum(h: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    err = h - target
    return (err * err.conj()).real.sum()


def make_sharded_training_step(mesh: DeviceMesh, cfg: ChannelConfig,
                               lr: float = 1e-3):
    """A training step of the complex loss (:func:`calib_loss`) on a mesh.

    Returns ``(step, place)``. ``place(params, paths, target)`` puts the
    training state on the mesh as DTensors: paths and the per-path
    corrections user-sharded, the target channels in
    :func:`~.mesh.channel_sharding`, the BS panel replicated and the UE
    panel's per-user [U, 3] rotation user-sharded (the rest replicated).
    ``step(params, paths, target)`` places what is not placed yet and
    returns ``(new_params, loss)``: the parameters in the same layout and
    the global loss, a plain scalar tensor equal on every rank.

    Each rank renders its users' slice of the target's last axis
    (:func:`_tile_block`) and takes the gradients of its sum of squared
    errors with autograd through the single-device entry points (the
    path-sum kernel with ``backend`` "pallas"). The loss is the mean over
    every user and subcarrier: one all-reduce over the whole mesh (users
    axis, then tile axis) carries the error and target-power sums and the
    replicated leaves' gradients; the per-user gradients are summed over
    the tile axis only, where ranks share users.
    """
    u_sh, r_sh = user_sharding(mesh), replicated(mesh)

    def place(params: CalibParams, paths: PathData, target: torch.Tensor):
        def panel(p: AntennaPanel, per_user: bool) -> AntennaPanel:
            return AntennaPanel(*(_place(
                x, mesh, u_sh if per_user and x.ndim == 2 else r_sh)
                for x in (p.rotation_deg, p.spacing)))

        params = CalibParams(
            panel(params.bs, False), panel(params.ue, True),
            *(_place(x, mesh, u_sh) for x in params.leaves()[4:]))
        return (params, shard_paths(paths, mesh),
                _place(target, mesh, channel_sharding(mesh, target.ndim)))

    def step(params: CalibParams, paths: PathData, target: torch.Tensor):
        params, paths, target = place(params, paths, target)
        n_ue = target.shape[0]
        u0, u1 = _user_rows(n_ue, mesh)
        leaves = params.leaves()
        shared = [not isinstance(x.placements[0], Shard) for x in leaves]
        lpaths = paths._map(lambda x: x.to_local())
        ltarget = target.to_local()

        # A replicated per-user rotation is cut to this rank's users.
        cut = [s and x.ndim == 2 for x, s in zip(leaves, shared)]

        def num(p: CalibParams, pd: PathData, tgt, c) -> torch.Tensor:
            bs, ue = (AntennaPanel(rot[u0:u1] if k else rot, x.spacing)
                      for x, rot, k in ((p.bs, p.bs.rotation_deg, cut[0]),
                                        (p.ue, p.ue.rotation_deg, cut[2])))
            pd = _apply_calib(pd, p)
            h, _ = _tile_block(lambda cc: render_channels(pd, bs, ue, cc),
                               c, mesh, _channel_field(c))
            return _sq_err_sum(h, tgt)

        err, grads = calib_value_and_grad(
            num, CalibParams.from_leaves([x.to_local() for x in leaves]),
            lpaths, ltarget, cfg)
        with torch.no_grad():
            den = (ltarget * ltarget.conj()).real.sum()
        grads = [torch.zeros_like(x.to_local()) if g is None else g
                 for x, g in zip(leaves, grads.leaves())]
        flat = torch.cat([err.reshape(1), den.reshape(1).to(err.dtype)] +
                         [g.reshape(-1) for g, s in zip(grads, shared) if s])
        for dim in (0, 1):
            dist.all_reduce(flat, group=mesh.get_group(dim))
        per_user = [g for g, s in zip(grads, shared) if not s]
        if mesh.size(1) > 1 and per_user:
            pu = torch.cat([g.reshape(-1) for g in per_user])
            dist.all_reduce(pu, group=mesh.get_group(1))
            per_user = _unflatten(pu, per_user)
        n = target.numel()
        scale = 1.0 / (n * (flat[1] / n + 1e-30))
        loss = flat[0] * scale
        shared_g = iter(_unflatten(flat[2:], [g for g, s in
                                              zip(grads, shared) if s]))
        per_user = iter(per_user)
        new = []
        for x, s in zip(leaves, shared):
            g = next(shared_g) if s else next(per_user)
            new.append(DTensor.from_local(
                x.to_local() - lr * scale * g, mesh, x.placements,
                run_check=False, shape=x.shape, stride=x.stride()))
        return CalibParams.from_leaves(new), loss

    return step, place


def _unflatten(flat: torch.Tensor, like: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    out, i = [], 0
    for x in like:
        out.append(flat[i:i + x.numel()].view_as(x))
        i += x.numel()
    return out
