"""The plain reference of the Uruv ADT: :class:`StoreMap`.

It imports nothing of the program: it works every answer out again from
the operations the benchmark generated, in announce order.
"""

from uruvbench.reference.store_map import (  # noqa: F401
    NOT_FOUND, OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE, OP_SEARCH, TOMBSTONE,
    StoreMap, sequential_apply,
)
