"""Published device peaks, keyed by ``jax.devices()[0].device_kind``, the
byte model that aggregation roofline shares are taken against, and the card's
own report of its name and power limit.

A device missing from the table is an error: a share against a guessed peak
is no measurement.
"""
from __future__ import annotations

import subprocess

PEAKS = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense (no sparsity)
    # rates at the 700 W power limit.
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "source": "NVIDIA H100 data sheet (SXM5, dense)",
    },
}


def peaks_for(device_kind: str) -> dict:
    """The peaks of ``device_kind``; raises ``KeyError`` for an unknown kind."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def aggregation_bytes(n_edge: int, n_dst: int, width: int, itemsize: int) -> int:
    """Least device-memory bytes of one weighted aggregation pass
    ``out[d] = sum_e w_e x[src_e]``: every edge gathers one source row
    (E*F*b), every destination row is written once (N*F*b), and every edge
    reads its source index, destination index and weight (E*12)."""
    return n_edge * width * itemsize + n_dst * width * itemsize + n_edge * 12


def bound_share(bytes_moved: float, seconds: float, device_kind: str) -> float:
    """Share of the device-memory bound: least time at peak bandwidth over the
    measured time."""
    return bytes_moved / peaks_for(device_kind)["hbm_bytes_per_s"] / seconds


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for each visible card. A card
    set below its top power limit runs slower under load, so every number
    taken on it is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
