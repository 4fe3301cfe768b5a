"""Durable writes (port of cruise_control_tpu/utils/persist.py).

Two disciplines, shared by every store that reaches disk (the executor
journal and the metric-sample store):

* **atomic publication**: `atomic_write` writes a temp file next to the
  target and `os.replace`s it into place, so a reader (or a process that
  crashes mid-write) never sees a torn file;
* **CRC-framed append logs**: `crc_frame` / `read_crc_json` give
  append-only JSONL logs a per-record crc32, so replay detects a torn
  tail (the record a dying process half-wrote) and truncates at the first
  bad record.

A frame is byte for byte the JAX package's, so a journal written by
either package replays in the other.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import IO, Iterable, List, Optional, Tuple


def fsync_file(fh) -> None:
    """Flush + fsync one open file object."""
    fh.flush()
    os.fsync(fh.fileno())


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so renames/creates inside it reach the disk
    journal (a rename is durable only once its directory entry is)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, fsync: bool = False) -> None:
    """Write-temp-then-rename publication of one complete file.

    The temp file lives NEXT TO the target (same filesystem, so the
    rename is atomic); on any failure the temp file is removed and the
    previous content of `path` is untouched.  With `fsync` the data
    and the directory entry are forced to disk before returning —
    journal-grade durability; without it the write is still atomic but
    rides the page cache (the program-cache trade-off)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-", suffix="~")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            if fsync:
                fsync_file(fh)
        os.replace(tmp, path)
        if fsync:
            fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, fsync: bool = False) -> None:
    atomic_write(path, json.dumps(obj, sort_keys=True,
                                  separators=(",", ":")).encode(),
                 fsync=fsync)



def atomic_rewrite(path: str, chunks: Iterable[bytes],
                   fsync: bool = False) -> int:
    """Compaction primitive: stream `chunks` into a temp file and
    atomically replace `path` with it (rewrite-temp-then-rename).
    Returns the number of bytes written.  The sample store's retention
    compaction uses it: the new content is a filtered stream of the old,
    never loaded into memory at once."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-", suffix="~")
    written = 0
    try:
        with os.fdopen(fd, "wb") as fh:
            for chunk in chunks:
                fh.write(chunk)
                written += len(chunk)
            if fsync:
                fsync_file(fh)
        os.replace(tmp, path)
        if fsync:
            fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return written

# ---------------------------------------------------------------------------
# CRC-framed JSONL records (append-only WAL framing)
# ---------------------------------------------------------------------------
def crc_frame(payload: bytes) -> bytes:
    """One framed record: `<8-hex-crc32> <payload>\\n`.  The payload
    must not contain newlines (compact JSON never does)."""
    return b"%08x %s\n" % (zlib.crc32(payload) & 0xFFFFFFFF, payload)


def json_frame(record: dict) -> bytes:
    return crc_frame(json.dumps(record, sort_keys=True,
                                separators=(",", ":")).encode())


def parse_crc_frame(line: bytes) -> Optional[bytes]:
    """The payload of one framed line, or None when the frame is bad
    (short line, bad hex, crc mismatch — all the torn-tail shapes)."""
    line = line.rstrip(b"\n")
    if len(line) < 10 or line[8:9] != b" ":
        return None
    try:
        want = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:]
    if zlib.crc32(payload) & 0xFFFFFFFF != want:
        return None
    return payload


def read_crc_json(path: str) -> Tuple[List[dict], bool]:
    """Replay one CRC-framed JSONL file: `(records, truncated)`.

    Reading stops at the FIRST bad record (crc mismatch, unparseable
    json, missing trailing newline on the last line): everything after
    a torn record is untrustworthy even if it frames correctly, so the
    tail is logically truncated — `truncated` tells the caller the
    file did not end cleanly."""
    records: List[dict] = []
    if not os.path.exists(path):
        return records, False
    with open(path, "rb") as fh:
        for raw in fh:
            if not raw.endswith(b"\n"):
                return records, True          # torn final record
            payload = parse_crc_frame(raw)
            if payload is None:
                return records, True
            try:
                records.append(json.loads(payload))
            except ValueError:
                return records, True
    return records, False


def open_append(path: str) -> IO[bytes]:
    """Open an append-only record log (the WAL segment handle)."""
    return open(path, "ab")
