"""Published peaks of the cards the benchmark knows (NVIDIA's data sheets,
at the full power limit). A card missing here gets no roofline share: its
readers return nothing."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def for_card(name):
    return PEAKS.get(name)
