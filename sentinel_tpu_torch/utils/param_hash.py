"""Deterministic 32-bit hashing of hot-param values (CMS/table keys).

Must agree across processes, hosts, and restarts — pod-level param-flow
aggregation and the cluster token protocol compare these hashes — so
Python's salted ``hash()`` is off-limits. Type-tagged CRC32 keeps 1, 1.0,
"1" and True distinct (the reference's ``ParamFlowItem`` distinguishes
values by declared classType — SURVEY.md §2.2).
"""

from __future__ import annotations

import struct
import zlib


def hash_param(value) -> int:
    if isinstance(value, bool):
        data = b"b1" if value else b"b0"
    elif isinstance(value, int):
        data = b"i" + str(value).encode()  # unbounded ints
    elif isinstance(value, float):
        data = b"f" + struct.pack("<d", value)
    elif isinstance(value, str):
        data = b"s" + value.encode("utf-8", "surrogatepass")
    elif isinstance(value, bytes):
        data = b"y" + value
    else:
        data = b"r" + repr(value).encode("utf-8", "backslashreplace")
    h = zlib.crc32(data) & 0xFFFFFFFF
    return h if h != 0 else 1
