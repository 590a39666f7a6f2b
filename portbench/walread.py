"""A plain reader of the ingest write-ahead log's framing, to judge what
the program logged (its own reader is not used to judge it).

Frame, little-endian: ``magic u32 "WAL1"``, ``type u8``, ``body_len
u32``, body, ``crc32 u32`` over type, length and body.  Type 1 (batch):
``n u32``, n f64 keys, n i64 payloads.  Type 2 (fence): ``epoch i64``;
a fence is written with an fsync, so every record before it is
durable once the fence is in the log.  The reader stops at the first
frame that is incomplete or fails its checksum.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x314C4157
HDR = struct.Struct("<IBI")


def read_log(path):
    """``(batches, fence_ends)``: each batch record as ``(keys,
    payloads, end)`` and the byte offset just past each fence, in log
    order (``end``: the offset just past the record)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, batches, fences = 0, [], []
    while pos + HDR.size <= len(data):
        magic, rtype, blen = HDR.unpack_from(data, pos)
        end = pos + HDR.size + blen
        if magic != MAGIC or end + 4 > len(data):
            break
        (crc,) = struct.unpack_from("<I", data, end)
        if crc != zlib.crc32(data[pos + 4:end]):
            break
        body = data[pos + HDR.size:end]
        pos = end + 4
        if rtype == 1:
            (n,) = struct.unpack_from("<I", body)
            if blen != 4 + 16 * n:
                break
            batches.append((np.frombuffer(body, np.float64, n, 4),
                            np.frombuffer(body, np.int64, n, 4 + 8 * n),
                            pos))
        elif rtype == 2:
            fences.append(pos)
        else:
            break
    return batches, np.asarray(fences, np.int64)


def lost_writes(keys, payloads, ack_ends, log) -> int:
    """Acknowledged written keys that were not durable at their
    acknowledgement: for each write (its keys, payloads and the log's
    size when it was acknowledged), a key counts unless a batch record
    holds it with its payload and a fence follows that record within
    the log as it stood at the acknowledgement."""
    if not keys:
        return 0
    ack = np.concatenate([np.full(k.size, a, np.int64)
                          for k, a in zip(keys, ack_ends)])
    keys = np.concatenate(keys)
    pays = np.concatenate(payloads)
    batches, fences = log
    if not batches:
        return int(keys.size)
    l_keys = np.concatenate([b[0] for b in batches])
    l_pays = np.concatenate([b[1] for b in batches])
    l_end = np.concatenate([np.full(b[0].size, b[2], np.int64)
                            for b in batches])
    order = np.argsort(l_keys, kind="stable")
    l_keys, l_pays, l_end = l_keys[order], l_pays[order], l_end[order]
    at = np.minimum(np.searchsorted(l_keys, keys), l_keys.size - 1)
    logged = (l_keys[at] == keys) & (l_pays[at] == pays)
    # the end of the first fence past each key's record (none: never)
    after = np.append(fences, np.iinfo(np.int64).max)
    fence_end = after[np.searchsorted(fences, l_end[at])]
    return int(np.count_nonzero(~(logged & (fence_end <= ack))))
