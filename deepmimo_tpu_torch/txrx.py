"""TX/RX set data model (scenario-format schema).

Represents transmitter/receiver sets as stored in params.json under
``txrx_sets``. Host code, copied from ``deepmimo_tpu.txrx``.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict, field
from typing import Dict, List, Tuple

from . import consts as c
from .utils import get_params_path, load_dict_from_json


@dataclass
class TxRxSet:
    """One set of transmitters or receivers in a ray-traced scenario."""

    name: str = ""
    id_orig: int = 0    # original ray-tracer ID
    id: int = 0         # DeepMIMO set index
    is_tx: bool = False
    is_rx: bool = False

    num_points: int = 0
    num_active_points: int = 0

    num_ant: int = 1
    dual_pol: bool = False

    ant_rel_positions: List = field(default_factory=lambda: [[0, 0, 0]])
    array_orientation: List = field(default_factory=lambda: [0, 0, 0])

    def to_dict(self) -> Dict:
        return asdict(self)

    def __repr__(self) -> str:
        role = ("TX" if self.is_tx else "") + ("RX" if self.is_rx else "")
        role = role or "Unknown"
        return (f"{role}Set(name='{self.name}', id={self.id}, "
                f"points={self.num_points})")


@dataclass
class TxRxPair:
    """A (transmitter index, receiver set) pairing."""

    tx: TxRxSet = field(default_factory=TxRxSet)
    rx: TxRxSet = field(default_factory=TxRxSet)
    tx_idx: int = 0

    def __repr__(self) -> str:
        return f"TxRxPair(tx={self.tx.name}[{self.tx_idx}], rx={self.rx.name})"

    def get_ids(self) -> Tuple[int, int]:
        return self.tx.id, self.rx.id


def get_txrx_sets(scenario_name: str) -> List[TxRxSet]:
    """All TX/RX sets declared in a scenario's params.json."""
    params = load_dict_from_json(get_params_path(scenario_name))
    return [TxRxSet(**val) for key, val in params[c.TXRX_PARAM_NAME].items()
            if key.startswith("txrx_set_")]


def get_txrx_pairs(txrx_sets: List[TxRxSet]) -> List[TxRxPair]:
    """Every (individual TX, RX set) combination."""
    tx_sets = [s for s in txrx_sets if s.is_tx]
    rx_sets = [s for s in txrx_sets if s.is_rx]
    return [TxRxPair(tx=tx_set, rx=rx_set, tx_idx=tx_idx)
            for tx_set in tx_sets
            for tx_idx in range(tx_set.num_points)
            for rx_set in rx_sets]


def print_available_txrx_pair_ids(scenario_name: str) -> None:
    """Print a table of all available TX-RX pair IDs for a scenario."""
    pairs = get_txrx_pairs(get_txrx_sets(scenario_name))
    print("\nTX/RX Pair IDs")
    print("-" * 25)
    print(f"{'Pair':^6} | {'TX ID':^6} | {'RX ID':^6}")
    print("-" * 25)
    for idx, pair in enumerate(pairs):
        tx_id, rx_id = pair.get_ids()
        print(f"{idx:^6} | {tx_id:^6} | {rx_id:^6}")
    print("-" * 25)
