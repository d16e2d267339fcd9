"""The peaks that roofline shares and MFU are taken against: one NVIDIA
H100 SXM (data sheet, dense rates, 700 W)."""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take for ``ops`` bf16 operations that
    move ``nbytes`` to or from HBM: the larger of the two bounds."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def share_percent(ops: float, nbytes: float, seconds: float):
    """The roofline share in percent of work that took ``seconds`` of
    device time; None where nothing ran."""
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) / seconds
