"""Write-ahead announce log: CRC-framed segments, group commit, torn tails.

A copy of the JAX package's ``repro.durability.wal`` (numpy, ``zlib`` and
``struct`` only): the format is byte-compatible, so the same plan stream
gives the same segment files, byte for byte, in both packages, and
either package opens the other's log.

One WAL record is one committed plan — ``(base_ts, codes, keys, values)``
with ``next_ts = base_ts + len(codes)`` — exactly the unit the executors
linearize, so replay at the recorded timestamps reproduces every version
timestamp bit-exactly (DESIGN.md Sec 14).  The on-disk format:

  segment file  wal_<seq:08d>.log
  ------------------------------------------------------------------
  segment header   8s  magic  b"URUVWAL1"
                   <I  seq    (must match the filename)
                   <I  crc32 of the seq field
  record           <I  magic  0x55525543
                   <I  payload length in bytes
                   <I  crc32 of the payload
  record payload   <iiI base_ts, next_ts, n   then codes/keys/values,
                   each ``n`` little-endian int32 words

Durability contract (confirm-after-fsync): a plan's result may only be
confirmed to a client after its record is on disk — the sync ``apply``
path appends + commits before returning, the pipelined path appends at
``Uruv.confirm`` time (a rejected plan is never logged; its replay logs
through ``apply``).  ``group_commit > 1`` relaxes this to a bounded
window: up to ``group_commit - 1`` confirmed plans may await the next
fsync (the classic group-commit throughput trade; ``commit(force=True)``
— and ``Coalescer.flush`` — close the window).

Open semantics (deterministic recover-or-reject, never half a plan):

  * a record that fails its frame checks in the FINAL segment ends the
    log: everything from that offset on is physically truncated and
    reported byte-exactly in :class:`WalReport` (a torn tail is the
    expected result of dying mid-append / pre-fsync);
  * invalid bytes in a NON-final segment are corruption, not a tail —
    later segments hold records the store may have confirmed, so
    truncating here could silently lose acknowledged plans:
    :class:`WalCorruptionError`;
  * duplicate records (a replayed/copied segment) parse fine here and
    are skipped at replay time by the ``next_ts <= store.ts`` rule in
    :mod:`repro_torch.durability.recovery`.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed.fault import crash_point

SEG_MAGIC = b"URUVWAL1"
SEG_HEADER = struct.Struct("<8sII")       # magic, seq, crc32(seq)
REC_MAGIC = 0x55525543                    # "URUC"
REC_HEADER = struct.Struct("<III")        # magic, payload_len, crc32(payload)
PAY_HEADER = struct.Struct("<iiI")        # base_ts, next_ts, n
_SEQ = struct.Struct("<I")

DEFAULT_SEGMENT_BYTES = 4 << 20


class WalCorruptionError(RuntimeError):
    """Invalid bytes somewhere other than the final segment's tail."""


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One committed plan: replay = apply at ``base_ts`` (Sec 14)."""

    base_ts: int
    next_ts: int
    codes: np.ndarray   # int32 [n]
    keys: np.ndarray    # int32 [n]
    values: np.ndarray  # int32 [n]

    def __len__(self) -> int:
        return int(self.codes.shape[0])


@dataclasses.dataclass
class WalReport:
    """What :func:`Wal.open` found — and exactly what it truncated."""

    n_records: int = 0
    n_segments: int = 0
    truncated_bytes: int = 0          # discarded from the final segment
    truncated_segment: Optional[str] = None
    torn_tail: bool = False

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return (f"WalReport(records={self.n_records}, "
                f"segments={self.n_segments}, "
                f"truncated={self.truncated_bytes}B"
                f"{' @' + self.truncated_segment if self.torn_tail else ''})")


def _segment_path(directory: Path, seq: int) -> Path:
    return directory / f"wal_{seq:08d}.log"


def _fsync_dir(directory: Path) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pack_record(base_ts: int, codes: np.ndarray, keys: np.ndarray,
                 values: np.ndarray) -> bytes:
    codes = np.ascontiguousarray(codes, dtype="<i4")
    keys = np.ascontiguousarray(keys, dtype="<i4")
    values = np.ascontiguousarray(values, dtype="<i4")
    n = codes.shape[0]
    if keys.shape[0] != n or values.shape[0] != n:
        raise ValueError("codes/keys/values must share one announce width")
    payload = (PAY_HEADER.pack(int(base_ts), int(base_ts) + n, n)
               + codes.tobytes() + keys.tobytes() + values.tobytes())
    return REC_HEADER.pack(REC_MAGIC, len(payload),
                           zlib.crc32(payload)) + payload


def _parse_payload(payload: bytes) -> WalRecord:
    base_ts, next_ts, n = PAY_HEADER.unpack_from(payload, 0)
    want = PAY_HEADER.size + 12 * n
    if len(payload) != want or next_ts != base_ts + n:
        raise ValueError("inconsistent record payload")
    off = PAY_HEADER.size
    arrs = [
        np.frombuffer(payload, dtype="<i4", count=n,
                      offset=off + 4 * n * i).astype(np.int32)
        for i in range(3)
    ]
    return WalRecord(base_ts, next_ts, *arrs)


def _scan_segment(path: Path, seq: int) -> Tuple[List[WalRecord], int, int]:
    """Parse one segment -> (records, valid_end_offset, file_size).

    Stops at the first frame that fails any check (short header, bad
    magic, bad CRC, inconsistent payload); the caller decides whether
    that is a torn tail (final segment) or corruption (earlier one).
    """
    data = path.read_bytes()
    if len(data) < SEG_HEADER.size:
        return [], 0, len(data)
    magic, hdr_seq, hdr_crc = SEG_HEADER.unpack_from(data, 0)
    if (magic != SEG_MAGIC or hdr_seq != seq
            or hdr_crc != zlib.crc32(_SEQ.pack(hdr_seq))):
        return [], 0, len(data)
    records: List[WalRecord] = []
    off = SEG_HEADER.size
    while True:
        if off + REC_HEADER.size > len(data):
            break
        magic, length, crc = REC_HEADER.unpack_from(data, off)
        end = off + REC_HEADER.size + length
        if magic != REC_MAGIC or end > len(data):
            break
        payload = data[off + REC_HEADER.size:end]
        if zlib.crc32(payload) != crc:
            break
        try:
            records.append(_parse_payload(payload))
        except ValueError:
            break
        off = end
    return records, off, len(data)


class Wal:
    """Append-only writer + validated reader over one WAL directory.

    Use :meth:`open` (it validates, truncates the torn tail, and
    positions the writer); ``append`` buffers one record, ``commit``
    makes everything appended so far durable (flush + fsync) — the
    fsync-bounded group commit: N appends per commit share one fsync.
    """

    def __init__(self, directory: Path, segments: List[int],
                 records: List[WalRecord], report: WalReport,
                 seg_max_ts: Dict[int, int], *,
                 segment_bytes: int, group_commit: int):
        self.dir = directory
        self.segment_bytes = segment_bytes
        self.group_commit = max(1, int(group_commit))
        self.report = report
        self._records = records
        self._segments = segments
        self._seg_max_ts = seg_max_ts
        self._pending = 0          # plans appended since the last fsync
        self._file = None
        if segments:
            self._seq = segments[-1]
            self._file = open(_segment_path(directory, self._seq), "ab")

    # ------------------------------------------------------------------ open
    @classmethod
    def open(cls, directory, *, segment_bytes: int = DEFAULT_SEGMENT_BYTES,
             group_commit: int = 1) -> "Wal":
        """Validate every segment, truncate the torn tail, open for append.

        Raises :class:`WalCorruptionError` for invalid bytes anywhere but
        the final segment's tail; ``wal.report`` says exactly how many
        bytes (if any) were truncated and from which file.
        """
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        paths = sorted(directory.glob("wal_*.log"))
        report = WalReport(n_segments=len(paths))
        records: List[WalRecord] = []
        seg_max_ts: Dict[int, int] = {}
        kept: List[int] = []
        for i, path in enumerate(paths):
            seq = int(path.stem.split("_")[1])
            recs, valid_end, size = _scan_segment(path, seq)
            final = i == len(paths) - 1
            if valid_end < size:
                if not final:
                    raise WalCorruptionError(
                        f"{path.name}: invalid bytes at offset {valid_end} "
                        f"in a non-final segment ({size - valid_end} bytes); "
                        "later segments may hold confirmed plans — refusing "
                        "to truncate")
                report.truncated_bytes = size - valid_end
                report.truncated_segment = path.name
                report.torn_tail = True
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
            if valid_end < SEG_HEADER.size:
                # not even a valid segment header survived — the file
                # never became a real segment (died inside _open_segment)
                path.unlink()
                continue
            kept.append(seq)
            records.extend(recs)
            if recs:
                seg_max_ts[seq] = recs[-1].next_ts
        report.n_records = len(records)
        return cls(directory, kept, records, report, seg_max_ts,
                   segment_bytes=segment_bytes, group_commit=group_commit)

    # ---------------------------------------------------------------- reading
    def records(self) -> List[WalRecord]:
        """Every validated record, in append order (replay input)."""
        return list(self._records)

    @property
    def last_ts(self) -> Optional[int]:
        return self._records[-1].next_ts if self._records else None

    # ---------------------------------------------------------------- writing
    def _open_segment(self, seq: int) -> None:
        path = _segment_path(self.dir, seq)
        f = open(path, "xb")
        f.write(SEG_HEADER.pack(SEG_MAGIC, seq, zlib.crc32(_SEQ.pack(seq))))
        f.flush()
        os.fsync(f.fileno())
        _fsync_dir(self.dir)               # the new name itself is durable
        self._segments.append(seq)
        self._seq = seq
        self._file = f

    def append(self, base_ts: int, codes, keys, values) -> None:
        """Buffer one plan record (no fsync — that is :meth:`commit`'s).

        The two writes around the ``wal.mid_append`` crash point are the
        fault-injection battery's torn-record generator: dying there
        leaves exactly half a record on disk, which the next
        :meth:`open` must truncate and report.
        """
        if self._file is None:
            self._open_segment(1)
        elif self._file.tell() >= self.segment_bytes:
            self.commit(force=True)        # never strand records behind
            self._file.close()             # a rotation boundary
            self._open_segment(self._seq + 1)
        rec = _pack_record(base_ts, np.asarray(codes), np.asarray(keys),
                           np.asarray(values))
        half = len(rec) // 2
        self._file.write(rec[:half])
        crash_point("wal.mid_append", flush=self._file.flush)
        self._file.write(rec[half:])
        self._records.append(_parse_payload(rec[REC_HEADER.size:]))
        self._seg_max_ts[self._seq] = self._records[-1].next_ts
        self._pending += 1

    def commit(self, force: bool = True) -> bool:
        """Make every appended record durable (flush + one fsync).

        ``force=False`` is the group-commit gate: fsync only once
        ``group_commit`` plans are pending, else leave them buffered.
        Returns whether an fsync happened.
        """
        if self._pending == 0 or self._file is None:
            return False
        if not force and self._pending < self.group_commit:
            return False
        self._file.flush()
        crash_point("wal.pre_fsync")
        os.fsync(self._file.fileno())
        crash_point("wal.post_fsync")
        self._pending = 0
        return True

    @property
    def pending(self) -> int:
        """Plans appended but not yet fsynced (the group-commit window)."""
        return self._pending

    # -------------------------------------------------------------------- gc
    def prune(self, min_ts: int) -> int:
        """Drop whole segments fully covered by a checkpoint at ``min_ts``
        (every record's ``next_ts <= min_ts``); never the open segment.
        Returns the number of segments removed."""
        removed = 0
        for seq in list(self._segments[:-1]):
            if self._seg_max_ts.get(seq, min_ts + 1) <= min_ts:
                _segment_path(self.dir, seq).unlink(missing_ok=True)
                self._segments.remove(seq)
                self._seg_max_ts.pop(seq, None)
                removed += 1
        if removed:
            _fsync_dir(self.dir)
        return removed

    def close(self) -> None:
        if self._file is not None:
            self.commit(force=True)
            self._file.close()
            self._file = None
