"""Content digests for end-to-end data integrity.

One fast digest shared by every data boundary: eager payloads,
rendezvous chunks, and checkpoint leaves.  The threat model is the
seeded fault injector's bit-flip
(and, in the real world, silent wire/storage corruption): we need to
*detect* flipped bytes cheaply, not authenticate them.

``digest_array`` is a vectorised 64-bit xor-fold: the byte stream is
viewed as little-endian ``uint64`` words, xor-reduced with numpy, and
mixed with any tail bytes plus the length.  This detects any single
bit-flip (and any odd corruption pattern) while running at memory
bandwidth (~18 GB/s on this container vs ~1.1 GB/s for ``zlib.crc32``)
— essential because the simulated wire moves 4 GB/s and the clean-path
overhead budget is ~5%.  It is order-*insensitive* across whole
aligned words (two swapped words cancel), which is fine here: chunk
identity and ordering are carried by the message ``seq``/``offset``
fields, the digest only guards the bytes themselves.
"""
from __future__ import annotations

from typing import Union

import numpy as np

_LEN_MIX = 0x9E3779B97F4A7C15  # golden-ratio odd constant
_MASK64 = 0xFFFFFFFFFFFFFFFF


class ChecksumError(RuntimeError):
    """Raised when stored/received bytes fail digest or metadata checks."""


def digest_array(arr: Union[np.ndarray, bytes, bytearray, memoryview]) -> int:
    """64-bit content digest of an array's (or buffer's) bytes.

    The result depends only on the raw byte stream and its length, not
    on shape or dtype — callers validate those separately from message
    meta / checkpoint manifests.
    """
    if isinstance(arr, (bytes, bytearray, memoryview)):
        b = np.frombuffer(arr, dtype=np.uint8)
    else:
        b = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    n = b.nbytes
    head = n - (n % 8)
    acc = 0
    if head:
        acc = int(np.bitwise_xor.reduce(b[:head].view(np.uint64)))
    if head != n:
        acc ^= int.from_bytes(b[head:].tobytes(), "little")
    return (acc ^ ((n * _LEN_MIX) & _MASK64)) & _MASK64


def verify_array(arr, expected: int) -> bool:
    """True iff ``arr``'s bytes hash to ``expected``."""
    return digest_array(arr) == int(expected)
