"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives.

The H100 SXM (NVIDIA's data sheet, dense, at the full 700 W limit):
989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM3.  ``int32_ops``
is not a data-sheet number: 132 SMs × 64 INT32 lanes × 1.98 GHz, the
most integer operations the CUDA cores can issue, which bounds work that
the tensor cores cannot do (the dither rounding's hash).
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["peaks"]

_H100_SXM = {"bf16_flops": 989e12, "int8_ops": 1979e12,
             "hbm_bytes": 3.35e12, "int32_ops": 132 * 64 * 1.98e9}

_TABLE = {"H100 80GB HBM3": _H100_SXM}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, None for a card not in the table."""
    for key, p in _TABLE.items():
        if key in device_name:
            return p
    return None
