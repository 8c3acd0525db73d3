"""Deferred-result surface of the public API: `PendingPlan`.

The serving front end (``repro_torch.serve.coalescer``) dispatches plan
N, builds plan N+1, and only then settles N.  The client primitive
behind that is the ``apply_nowait`` / ``confirm`` pair:

  * ``Uruv.apply_nowait(batch)`` runs ONE fast-path pass for a CRUD-only
    plan and returns a :class:`PendingPlan` — the speculative store, the
    result values and the accept flag; the client adopts the speculative
    store so further plans can be dispatched behind it.
  * ``Uruv.confirm(pending)`` settles it: on acceptance it materialises
    the per-op ``Result``; on rejection it rolls the client back to the
    pre-plan store and returns ``None``, and the caller replays the plan
    through the synchronous ``apply`` path.

Speculation is safe because ``store.bulk_apply`` rejects atomically: a
rejected pass returns the input store (plus the ``oflow`` bits) and does
not advance the clock.  In the port the accept flag is already a host
bool when ``apply_nowait`` returns (its pass reads the flags on the
host); the protocol is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.api.opbatch import OpBatch


@dataclasses.dataclass
class PendingPlan:
    """One dispatched-but-unconfirmed CRUD plan (see module docstring).

    ``batch`` is the plan exactly as dispatched (padding included) with
    numpy fields, so a rejected plan replays bit-exactly.  ``n_user`` is
    the caller's pre-padding width.  ``store_before`` is ``None`` when the
    caller asked to donate the store; rollback then recovers the pre-plan
    state from the rejected ``store_after``.
    """

    batch: OpBatch
    n_user: int
    store_before: Optional[Any]     # pre-dispatch store (not donated)
    store_after: Any                # speculative store
    values: torch.Tensor            # int32 [P] result values (speculative)
    ok: bool                        # accept flag

    @property
    def plan_id(self) -> int:
        """The plan id ``repro_torch.tracing`` gave this dispatch (0 when
        tracing was off); its confirm and a replay of ``batch`` carry it."""
        return self.batch.plan_id

    def rollback_store(self):
        """The pre-plan store: the held reference, or the rejected pass's
        passthrough store with its overflow bits cleared."""
        if self.store_before is not None:
            return self.store_before
        return dataclasses.replace(
            self.store_after, oflow=torch.zeros_like(self.store_after.oflow))
