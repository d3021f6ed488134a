"""The table of peaks and the byte bound of a codec call.

An LZ4 call's least time on the card is its bytes over the memory
bandwidth: every input byte read once and every output byte written once.
Its integer work (some 16 operations a byte at 67 TOP/s) bounds it lower,
so the byte bound is the roofline. Peaks are NVIDIA's data sheet for the
H100 SXM at its 700 W limit; a card set below it reads lower shares.
"""

from __future__ import annotations

PEAKS = {
    # name as torch.cuda.get_device_name() gives it: HBM bytes per second
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
DEFAULT_PEAK = 3.35e12  # the H100 SXM's, for a name the table lacks


def peak_bytes_per_s(kind: str) -> float:
    return PEAKS.get(kind, DEFAULT_PEAK)


def byte_bound_s(bytes_read: int, bytes_written: int, kind: str) -> float:
    """The least time a call that reads and writes these bytes can take."""
    return (bytes_read + bytes_written) / peak_bytes_per_s(kind)
