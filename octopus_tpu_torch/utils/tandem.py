"""Exact tandem repeat finding on base-code arrays.

Bit-exact to the reference's vendored tandem library (lib/tandem/
tandem.hpp extract_exact_tandem_repeats), which the error models call with
(1, 3) [SNV model] and (1, 5) [indel model].  The reference dispatches on
max_period: a naive per-period scan for max_period <= 3 and the
Kolpakov-Kucherov maximal-repetition algorithm over a Lempel-Ziv
factorisation otherwise — the two report runs with different anchoring, so
both run in the host extension (csrc/octopus_native.cpp:tandem_repeats,
tandem_exact), fuzz-verified against the reference library driven in
place (tests/golden/golden_tandem.cpp, tests/test_tandem_golden.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# native single-pass scanner (csrc/octopus_native.cpp:tandem_repeats), built
# at first use
from .._build import NATIVE as _native


@dataclass(frozen=True)
class Repeat:
    pos: int
    length: int  # total span in bases (>= 2 * period)
    period: int


def extract_exact_tandem_repeats_arrays(
    codes: np.ndarray, min_period: int = 1, max_period: int = 3
) -> np.ndarray:
    """(n, 3) int32 [pos, length, period] rows, sorted by position —
    the array form of extract_exact_tandem_repeats (no object churn for
    hot consumers)."""
    raw = _native.tandem_repeats(
        np.ascontiguousarray(codes, dtype=np.uint8).tobytes(),
        int(min_period), int(max_period))
    return np.frombuffer(raw, dtype=np.int32).reshape(-1, 3)


def extract_exact_tandem_repeats(
    codes: np.ndarray, min_period: int = 1, max_period: int = 3
) -> list[Repeat]:
    """All maximal exact tandem repeats with primitive period in range,
    sorted by position."""
    trip = extract_exact_tandem_repeats_arrays(codes, min_period, max_period)
    return [Repeat(int(p), int(l), int(q)) for p, l, q in trip]


__all__ = ["Repeat", "extract_exact_tandem_repeats",
           "extract_exact_tandem_repeats_arrays"]
