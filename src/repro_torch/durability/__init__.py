"""Durability of the port: write-ahead announce log + delta checkpoints
+ recovery, byte-compatible with the JAX package's ``repro.durability``.

The announce array is already a replayable record: every committed plan
is ``(base_ts, codes, keys, values)`` and the store's ``op_ts`` plumbing
makes re-application at the original timestamps bit-exact:

  * :mod:`repro_torch.durability.wal` — append-only CRC-framed segments
    with fsync-bounded group commit and torn-tail detection-and-truncate.
  * :mod:`repro_torch.durability.recovery` — the ``Durability`` sidecar
    the executors log through, and :func:`recover`: restore the last
    complete checkpoint (full or base + delta chain, see
    ``repro_torch.checkpoint.manager``) and replay the WAL tail at its
    recorded timestamps, on the card unless the caller asks for the CPU.

A directory written by either package recovers in the other.  Nothing
on the replay path reads a wall clock or a host RNG.
"""

from repro_torch.durability.wal import (  # noqa: F401
    Wal, WalCorruptionError, WalRecord, WalReport,
)
from repro_torch.durability.recovery import (  # noqa: F401
    Durability, WalReplayError, recover,
)
