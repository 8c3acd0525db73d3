#!/usr/bin/env python3
"""One piece of a tree's ``chip_smoke.py``, alone in a fresh process, for
A/B runs of the PyTorch port between two trees on one card.

    python3 scripts/port_ab.py serve TREE   # the serve phase, fresh generator
    python3 scripts/port_ab.py flash TREE   # the flash forward at the serve shape

``TREE`` is a checkout of the repository (e.g. the parent's ``git
archive`` and the change's, unpacked under ``build/``).  Run it in turns,
P C C P ..., inside one call on one card.  ``serve`` prints the serve
phase's line; ``flash`` prints the wrapper time (``time_ms``) and three
device-time readings (``device_ms``) of ``flash_attention`` at B 1, H 32,
KVH 8, S 309, D 64, bf16, causal, on seeded inputs.  Both use the tree's
own ``chip_smoke.py`` functions and kernels.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    what, tree = sys.argv[1], Path(sys.argv[2]).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if what == "serve":
        _build.build(_build.SOURCES)
        cs.serve_phase(types.SimpleNamespace(seed=0),
                       np.random.default_rng(0))
        return 0
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention)

    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).cuda().bfloat16()
               for s in ((1, 32, 309, 64), (1, 8, 309, 64), (1, 8, 309, 64)))

    def run():
        return flash_attention(q, k, v, causal=True, window=0)
    ms = cs.time_ms(run)
    dev = [cs.device_ms(run)[0] for _ in range(3)]
    print(f"ms={ms:.5f} device_ms=" + ",".join(f"{d:.5f}" for d in dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
