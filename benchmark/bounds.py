"""The yardstick for roofline shares: the card's peaks and the least time a
kernel's work could take on it.

Frozen copies of ``chip_smoke.py``'s peaks and ``int8_bound_ms``, so that no
later change to the program can move them. Peaks are NVIDIA's H100 SXM
data sheet's, dense: int8 tensor cores and HBM3.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def int8_bound_ms(b: int, n: int, d: int, s: int, keep: int) -> tuple[float, str]:
    """The least time for an exhaustive int8 scan of ``b`` queries over
    ``n`` rows of width ``d`` that keeps the best ``keep`` of each of ``s``
    slots: 2*B*N*D int8 operations at the dense tensor-core peak, or its
    bytes (queries, codes, scales and mask read once, the [B, keep*S]
    scores and ids written once) at the HBM rate, whichever is larger.
    Returns the milliseconds and which of the two binds."""
    ops_ms = 2 * b * n * d / INT8_OPS_PER_S * 1e3
    bytes_ms = (b * d + n * d + 5 * n + 8 * b * keep * s) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
