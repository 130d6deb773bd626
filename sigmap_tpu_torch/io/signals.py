"""Raw-signal containers and the directory loader.

Replaces SignalBatch loading (signal_batch.cc:23-210).  Raw DAC values are
converted to picoamps with (raw + offset) * range / digitisation and samples
outside the open interval (30, 200) pA are *dropped* (not clipped), matching
signal_batch.cc:139-151.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class ReadSignal:
    read_id: str
    digitisation: float
    range: float
    offset: float
    pa: np.ndarray  # float32 picoamp samples after validity filtering

    @property
    def length(self) -> int:
        return len(self.pa)


def dac_to_pa(
    raw: np.ndarray, digitisation: float, rng: float, offset: float,
    pa_lo: float = 30.0, pa_hi: float = 200.0,
) -> np.ndarray:
    scale = rng / digitisation
    pa = (raw.astype(np.float32) + np.float32(offset)) * np.float32(scale)
    return pa[(pa > pa_lo) & (pa < pa_hi)]


def scan_signal_files(directory: str) -> tuple[list[str], list[str]]:
    """Recursively find .fast5 and .blow5/.slow5 files.

    Reference walks with readdir order (signal_batch.cc:25-55); we sort for
    deterministic output order.
    """
    fast5s: list[str] = []
    slow5s: list[str] = []
    for root, dirs, files in os.walk(directory):
        dirs.sort()
        for fn in sorted(files):
            p = os.path.join(root, fn)
            if ".fast5" in fn:
                fast5s.append(p)
            elif ".blow5" in fn or ".slow5" in fn:
                slow5s.append(p)
    return fast5s, slow5s


def load_all_read_signals(
    directory: str, pa_lo: float = 30.0, pa_hi: float = 200.0
) -> list[ReadSignal]:
    """SignalBatch::LoadAllReadSignals (signal_batch.cc:23-66): fast5 files
    first, then blow5/slow5."""
    from .fast5 import read_fast5
    from .slow5 import read_slow5

    fast5s, slow5s = scan_signal_files(directory)
    signals: list[ReadSignal] = []
    for p in fast5s:
        signals.extend(read_fast5(p, pa_lo=pa_lo, pa_hi=pa_hi))
    for p in slow5s:
        signals.extend(read_slow5(p, pa_lo=pa_lo, pa_hi=pa_hi))
    return signals
