"""repro_torch.api — the public entry point to the PyTorch port of Uruv.

  * :class:`OpBatch`  — the typed announce-array plan (builders
    ``inserts/deletes/searches/ranges/updates``, ``concat``, ``pad_to``).
  * :class:`Result`   — per-op values + found mask + timestamps + complete
    range pages and resume frontiers.
  * :class:`Uruv`     — the client: ``apply(batch)``, convenience verbs,
    the pipelined ``apply_nowait``/``confirm``, ``snapshot()``,
    ``range``/``range_all``/``range_page``/``scan_page``, ``compact()``,
    ``reindex()``, ``maintain()``, ``grow()``, and the durable verbs
    (``durable_dir=``, ``checkpoint()``, ``sync_durable()``,
    ``Uruv.recover``; see ``repro_torch.durability``).  It runs on
    ``cuda`` unless given ``device="cpu"``.
  * :class:`PendingPlan` — a dispatched, unconfirmed plan.
  * :class:`LocalExecutor` / :class:`ShardedExecutor` — the execution
    backends: one store, or a key-range-sharded stacked store
    (``Uruv.sharded(ShardedConfig(...), make_host_mesh(n))``).
  * :class:`LifecyclePolicy` — the store lifecycle; the default is
    self-sizing (pools grow, maintenance interleaves), and
    :data:`FIXED_FOOTPRINT` keeps the configured pools with
    ``CapacityError`` as its contract.
"""

from repro_torch.core.batch import CapacityError
from repro_torch.core.ref import (
    KEY_DOMAIN_HI, KEY_MAX, NOT_FOUND, TOMBSTONE,
    OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE, OP_SEARCH,
)
from repro_torch.core.sharded import ShardedConfig
from repro_torch.core.store import UruvConfig

from repro_torch.api.client import Uruv
from repro_torch.api.executors import (
    FIXED_FOOTPRINT, LifecyclePolicy, LocalExecutor, RangeOptions,
    ShardedExecutor,
)
from repro_torch.api.futures import PendingPlan
from repro_torch.api.opbatch import (
    OpBatch, RangePage, Result, make_result, pow2_width,
)

__all__ = [
    "CapacityError",
    "FIXED_FOOTPRINT",
    "KEY_DOMAIN_HI",
    "KEY_MAX",
    "LifecyclePolicy",
    "LocalExecutor",
    "NOT_FOUND",
    "OP_DELETE",
    "OP_INSERT",
    "OP_NOP",
    "OP_RANGE",
    "OP_SEARCH",
    "OpBatch",
    "PendingPlan",
    "RangeOptions",
    "RangePage",
    "Result",
    "ShardedConfig",
    "ShardedExecutor",
    "TOMBSTONE",
    "Uruv",
    "UruvConfig",
    "make_result",
    "pow2_width",
]
