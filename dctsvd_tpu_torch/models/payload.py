"""Text / JSON payload watermarks via bit-plane images (a copy of
``dctsvd_tpu/models/payload.py``, which imports only json and numpy).

Payload bytes get a 4-byte little-endian length header, are unpacked to
bits (each repeated ``repeat`` times, a repetition code decoded by
majority vote), drawn as a 0/255 bit-plane of the host's size, and
embedded through the gray pipeline of either method; the meta records
``payload_type`` ('text' | 'json' | 'bytes') and ``repeat``
(ref: dct_svd_core_secure.py:56-82,101-131,210-243).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple, Union

import numpy as np


HEADER_BYTES = 4


def payload_to_bytes(payload: Union[str, dict, bytes],
                     payload_type: Optional[str] = None
                     ) -> Tuple[bytes, str]:
    if isinstance(payload, bytes):
        return payload, payload_type or "bytes"
    if isinstance(payload, str):
        return payload.encode("utf-8"), payload_type or "text"
    return json.dumps(payload).encode("utf-8"), payload_type or "json"


def bytes_to_payload(data: bytes, payload_type: str):
    if payload_type == "json":
        return json.loads(data.decode("utf-8"))
    if payload_type == "text":
        return data.decode("utf-8")
    return data


def bytes_to_bitplane(data: bytes, h: int, w: int,
                      repeat: int = 1) -> np.ndarray:
    """bytes -> 0/255 uint8 [h, w] plane: 4-byte LE length ‖ payload bits,
    each bit replicated `repeat` times, zero-padded to h*w."""
    if repeat < 1:
        # np.repeat(bits, 0) would silently embed an all-zero plane (the
        # payload vanishes with no error) and decode would divide by zero
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    header = len(data).to_bytes(HEADER_BYTES, "little")
    bits = np.unpackbits(np.frombuffer(header + data, np.uint8))
    bits = np.repeat(bits, repeat)
    if bits.size > h * w:
        raise ValueError(
            f"Payload too large: {len(data)} bytes * {repeat}x repetition "
            f"needs {bits.size} pixels, host has {h * w}.")
    plane = np.zeros(h * w, np.uint8)
    plane[:bits.size] = bits * 255
    return plane.reshape(h, w)


def bitplane_to_bytes(plane: np.ndarray, repeat: int = 1) -> bytes:
    """Inverse of :func:`bytes_to_bitplane` with majority vote over the
    repetition groups and threshold at 127."""
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    flat = (plane.reshape(-1) > 127).astype(np.uint8)
    usable = flat[: (flat.size // repeat) * repeat]
    if repeat > 1:
        groups = usable.reshape(-1, repeat)
        bits = (groups.sum(axis=1) * 2 > repeat).astype(np.uint8)
    else:
        bits = usable
    raw = np.packbits(bits).tobytes()
    n = int.from_bytes(raw[:HEADER_BYTES], "little")
    if n < 0 or HEADER_BYTES + n > len(raw):
        raise ValueError("Corrupted payload header after extraction.")
    return raw[HEADER_BYTES:HEADER_BYTES + n]
