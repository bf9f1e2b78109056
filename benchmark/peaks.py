"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheets,
SXM parts, dense rates without sparsity, at the full power limit)."""

from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flop_per_s": 989e12, "hbm_byte_per_s": 3.35e12},
}


def peak(device_name: str) -> dict:
    for part, p in PEAKS.items():
        if part in device_name:
            return p
    raise KeyError(f"no published peak for {device_name!r}")
