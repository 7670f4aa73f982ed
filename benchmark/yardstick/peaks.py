"""Published peaks of the cards the benchmark knows (NVIDIA data sheets,
dense rates), frozen here so that the yardstick does not move with the
program. Card name (a substring of torch.cuda.get_device_name) -> peak HBM
bytes/s and FP32 flop/s outside the tensor cores; the first match wins."""

from __future__ import annotations

CARDS = (
    ("H100 80GB HBM3", 3350e9, 67e12),   # H100 SXM
    ("H100 PCIe", 2000e9, 51e12),
    ("H100 NVL", 3900e9, 60e12),
    ("H200 NVL", 4800e9, 60e12),
    ("H200", 4800e9, 67e12),
)


def card_peaks(name: str) -> tuple[float, float] | None:
    """(HBM bytes/s, FP32 flop/s) of card `name`, or None for a card the
    table does not know: no peak is assumed."""
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
    return None


def least_seconds(nbytes: float, nflop: float, peaks: tuple[float, float]) -> float:
    """The least time the card could take: bytes over the HBM rate or flops
    over the FP32 rate, whichever is larger."""
    return max(nbytes / peaks[0], nflop / peaks[1])
