"""What every kind's check shares: the control's precision for each
configuration dtype, and each number held against its limit in
``bench/cells/<cell>.json``.  A kind's own comparison with the plain
reference lives beside its driver (``bench/traffic/<kind>.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

# the control's rounding for each configuration dtype: the reference in
# the nearest precision below it
CONTROL = {"bfloat16": "fp8", "float16": "fp8"}


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} in the order of ``limits``."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
