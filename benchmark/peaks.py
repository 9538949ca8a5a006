"""The card's published peaks (``peaks.json``), by the name the card
gives itself."""

from __future__ import annotations

import json
import os
from typing import Optional

_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peak(facts: dict, what: str) -> Optional[float]:
    """The peak FLOP/s of the run's dtype (``what="flops"``) or the memory
    bandwidth in bytes/s (``"bytes"``) of the run's card; None for a card
    the table does not hold."""
    with open(_PATH) as f:
        card = json.load(f).get(facts.get("device_kind", ""))
    if card is None:
        return None
    if what == "bytes":
        return card["bytes_per_s"]
    return card["flops"].get(facts.get("dtype", ""))
