"""Adapter feeding DeepMIMO channels into Sionna link-level simulations.

Yields ``(a, tau)`` numpy arrays in Sionna's CIR layout
``a: [num_rx, num_rx_ant, num_tx, num_tx_ant, num_paths, num_time_steps]``
(complex64), ``tau: [num_rx, num_tx, num_paths]`` (float32). Accepts the
port's Dataset / MacroDataset (time-domain channels are computed on demand,
on ``config['device']``) as well as v3-style
``dataset[bs]['user']['channel']`` dicts. Copied from
``deepmimo_tpu/integrations/sionna_adapter.py`` with one fix: under a
field of view the time-domain channel packs each user's kept paths to the
front, and the delays are packed the same way, so ``tau[j]`` is the delay
of the path whose gain sits in column ``j``. The JAX adapter takes the
delays unpacked.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import consts as c


class DeepMIMOSionnaAdapter:
    """Generator of Sionna-format channel impulse responses."""

    def __init__(self, DeepMIMO_dataset, bs_idx=None, ue_idx=None) -> None:
        self._channels, self._delays = self._extract(DeepMIMO_dataset)
        n_bs = len(self._channels)

        if bs_idx is None:
            bs_idx = np.array([[0]])
        self.bs_idx = self._verify_idx(bs_idx)
        if ue_idx is None:
            ue_idx = np.arange(self._channels[0].shape[0])
        self.ue_idx = self._verify_idx(ue_idx)

        if self.bs_idx.max() >= n_bs:
            raise ValueError(f"bs_idx out of range (dataset has {n_bs} BSs)")

        self.num_rx_ant = self._channels[0].shape[1]
        self.num_tx_ant = self._channels[0].shape[2]
        self.num_paths = self._channels[0].shape[-1]

        self.num_samples_bs = self.bs_idx.shape[0]
        self.num_samples_ue = self.ue_idx.shape[0]
        self.num_samples = self.num_samples_bs * self.num_samples_ue
        self.num_rx = self.ue_idx.shape[1]
        self.num_tx = self.bs_idx.shape[1]
        self.num_time_steps = 1

        self.ch_shape = (self.num_rx, self.num_rx_ant, self.num_tx,
                         self.num_tx_ant, self.num_paths,
                         self.num_time_steps)
        self.t_shape = (self.num_rx, self.num_tx, self.num_paths)

    # ------------------------------------------------------------------
    def _extract(self, dataset) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Per-BS (time-domain channel, delay) arrays from any layout."""
        from ..generator.dataset import Dataset, MacroDataset
        from ..generator.params import ChannelGenParameters
        from ..ops.channel import td_path_delays

        def from_ds(ds: Dataset):
            ch = ds.get(c.CHANNEL_PARAM_NAME)
            params = ds.get(c.CH_PARAMS_PARAM_NAME)
            needs_td = ch is None or (params is not None and
                                      params[c.PARAMSET_FD_CH])
            if needs_td:
                params = (params.deepcopy() if params is not None
                          else ChannelGenParameters())
                params[c.PARAMSET_FD_CH] = 0
                ch = ds.compute_channels(params)
            # The delays of the channel's columns, in the render's order.
            _, cfg, bs, ue = ds._channel_config(params)
            tau = td_path_delays(ds._path_data(), bs, ue, cfg)
            return np.asarray(ch), tau.cpu().numpy()

        if isinstance(dataset, MacroDataset):
            pairs = [from_ds(d) for d in dataset.datasets]
        elif isinstance(dataset, Dataset):
            pairs = [from_ds(dataset)]
        else:
            # v3-style list of dicts: dataset[b]['user']['channel'/'paths']
            pairs = []
            for bs_data in dataset:
                user = bs_data["user"]
                ch = np.asarray(user["channel"])
                if "delay" in user:
                    tau = np.asarray(user["delay"])
                else:
                    tau = np.stack([np.asarray(p["ToA"]).reshape(-1)
                                    for p in user["paths"]])
                pairs.append((ch, tau))
        return [p[0] for p in pairs], [p[1] for p in pairs]

    # ------------------------------------------------------------------
    def _verify_idx(self, idx) -> np.ndarray:
        if isinstance(idx, (int, np.integer)):
            idx = np.array([[idx]])
        elif isinstance(idx, (list, range)):
            idx = np.array(idx)
        elif not isinstance(idx, np.ndarray):
            raise TypeError(f"Invalid index type: {type(idx)}")
        if idx.ndim == 1:
            idx = idx.reshape(-1, 1)
        elif idx.ndim != 2:
            raise ValueError("Indices must be 1D or 2D")
        return idx

    def __len__(self) -> int:
        return self.num_samples

    def __call__(self):
        """Yield (a, tau) for every (bs sample, ue sample) combination."""
        for bs_row in self.bs_idx:
            for ue_row in self.ue_idx:
                a = np.zeros(self.ch_shape, dtype=np.csingle)
                tau = np.zeros(self.t_shape, dtype=np.single)
                for t_i, bs in enumerate(bs_row):
                    ch = self._channels[bs]
                    dl = self._delays[bs]
                    for r_i, ue in enumerate(ue_row):
                        n_p = min(self.num_paths, ch.shape[-1])
                        a[r_i, :, t_i, :, :n_p, 0] = ch[ue][..., :n_p]
                        d = np.nan_to_num(dl[ue][:n_p], nan=0.0)
                        tau[r_i, t_i, :len(d)] = d
                yield a, tau
