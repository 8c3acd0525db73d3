#!/usr/bin/env python3
"""The control of ``correct``: the plain reference in the program's place,
with one guarantee of the configuration broken.

    python3 uruvbench/control.py --workload paper-fig9b-w16k \
        --seeds 11,12,13 --seconds 10

The store states that op ``i`` of a plan runs at timestamp ``ts + i``
and sees every op before it.  :class:`StaleReadStore` answers every op
of a plan from the state the plan found (its writes land at the plan's
end, the last one to a key winning), which is what a store that dropped
in-plan linearization would answer.  The harness drives it through the
cell's own window and check, in place of ``repro_torch.api.Uruv``; each
seed must come out not correct.  It runs on the host only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


class StaleReadStore:
    """The surface of ``repro_torch.api.Uruv`` that the loops and the
    front end call, answered by a NumPy map that reads at plan start."""

    def __init__(self, config=None, *, device=None, policy=None):
        from uruvbench.reference import StoreMap

        self.map = StoreMap(0)
        self._ts = 0
        self.stats = {"device_passes": 0, "slow_path_rounds": 0}

    def _grow(self, keys) -> None:
        from uruvbench.reference import NOT_FOUND

        need = int(np.max(keys, initial=0))
        if need >= len(self.map.val):
            val = np.full(need + 1, NOT_FOUND, np.int32)
            val[:len(self.map.val)] = self.map.val
            self.map.val = val

    def _answer(self, batch):
        from uruvbench.reference import OP_NOP, OP_RANGE
        from repro_torch.api.opbatch import make_result

        codes, keys, values = (np.asarray(batch.codes),
                               np.asarray(batch.keys, np.int64),
                               np.asarray(batch.values, np.int64))
        crud = (codes != OP_RANGE) & (codes != OP_NOP)
        self._grow(keys[crud])
        before = self.map.val.copy() if crud.any() else self.map.val
        frozen = type(self.map)(0)
        frozen.val = before
        out = np.full(len(codes), -1, np.int64)
        out[crud] = before[keys[crud]]
        items = []
        for pos in np.flatnonzero(codes == OP_RANGE).tolist():
            page = frozen.range(int(keys[pos]), int(values[pos]))
            out[pos] = len(page)
            items.append((pos, [tuple(p) for p in page.tolist()], 0))
        self.map._crud(np.where(crud, codes, OP_NOP), keys, values)
        base = self._ts
        self._ts += len(codes)
        self.stats["device_passes"] += 1
        return make_result(out, codes, base, items)

    @property
    def ts(self):
        return self._ts

    def apply(self, batch, **_):
        return self._answer(batch)

    def apply_nowait(self, batch, **_):
        from repro_torch.api import PendingPlan

        return PendingPlan(batch=batch, n_user=len(batch), store_before=None,
                           store_after=self._answer(batch), values=None,
                           ok=True)

    def confirm(self, pending):
        return pending.store_after

    def sync_durable(self):
        pass

    def lifecycle_tick(self):
        pass

    def live_items(self):
        return [tuple(p) for p in self.map.live_items().tolist()]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from repro_torch import api
    from uruvbench import harness

    api.Uruv = StaleReadStore
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        line = harness.run(ROOT, args.workload, seed, args.seconds, False,
                           device="cpu")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "s": round(time.perf_counter() - t, 1),
                          "checks": {k: c["value"] for k, c in
                                     line["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
