"""Environment-driven defaults, resolved at the layers that build cores.

The consensus cores are sans-io, so `HYDRABADGER_RBC` is read here, by
sim/network.py, and flows down as an explicit argument."""
from __future__ import annotations

import os
from typing import Optional

from ..consensus.broadcast import VARIANTS as RBC_VARIANTS


def resolve_rbc_variant(value: Optional[str] = None) -> str:
    """Explicit value > `HYDRABADGER_RBC` env > "bracha"."""
    if value is None:
        value = os.environ.get("HYDRABADGER_RBC", "") or "bracha"
    if value not in RBC_VARIANTS:
        raise ValueError(f"unknown RBC variant {value!r}; have {RBC_VARIANTS}")
    return value
