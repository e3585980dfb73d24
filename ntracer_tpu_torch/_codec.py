"""IEEE-754 float32 byte codec used by the pickle protocol.

The reference (see src/render.cpp:1405-1477,
``encode_float_ieee754``/``decode_float_ieee754``) serializes all geometry as
big-endian IEEE-754 float32 byte strings so pickles are portable across
platforms.  We keep the exact same byte format so pickles interoperate with
the original C++ extension.
"""

from __future__ import annotations

import numpy as np

__all__ = ["encode_floats", "decode_floats"]


def encode_floats(values) -> bytes:
    """Encode a flat iterable/array of float32 as big-endian IEEE-754 bytes."""
    a = np.asarray(values, dtype=np.float32).ravel()
    return a.astype(">f4").tobytes()


def decode_floats(data: bytes, count: int | None = None) -> np.ndarray:
    """Decode big-endian IEEE-754 float32 bytes to a float32 array."""
    a = np.frombuffer(data, dtype=">f4", count=-1 if count is None else count)
    return a.astype(np.float32)
