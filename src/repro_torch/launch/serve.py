"""CLI server driver: batched generation through the continuous-batching
engine of the port, with seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \\
      --requests 6 --max-new 8                       # full width, on cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \\
      --reduced --device cpu                         # tiny, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b \\
      --max-len 512                                  # MoE, full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2_7b \\
      --max-len 256                                  # hybrid, full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_350m \\
      --reduced --device cpu                         # xLSTM, tiny

Every family with a decode step serves (dense, MoE, VLM as text, the
hybrid zamba2 and the xLSTM, whose prompts the engine feeds token by
token); the encoder-only model has none and is refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_arch
from repro_torch.core.store import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Engine, Request


def build_engine(arch: str, *, reduced: bool = False, seed: int = 0,
                 slots: int = 4, max_len: int = 64,
                 device="cuda") -> Engine:
    """The serving engine for ``arch`` with weights drawn from ``seed`` on
    ``device``."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    if api.decode_step is None:
        raise SystemExit(f"{cfg.name} is encoder-only: no serve path")
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    return Engine(cfg, params, n_slots=slots, max_len=max_len, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    eng = build_engine(args.arch, reduced=args.reduced, seed=args.seed,
                       slots=args.slots, max_len=args.max_len,
                       device=args.device)
    cfg, dev = eng.cfg, eng.device

    rng = np.random.default_rng(args.seed)
    shared_prefix = rng.integers(0, cfg.vocab, 6).tolist()
    reqs = []
    for i in range(args.requests):
        prompt = shared_prefix + rng.integers(0, cfg.vocab,
                                              3 + i % 3).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new=args.max_new))

    t0 = time.time()
    eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt {len(r.prompt)} "
              f"reused_prefix {r.prefix_reused} out {r.out}")
    print(f"{toks} tokens in {dt:.2f}s = {toks/dt:.1f} tok/s "
          f"(batched decode, {args.slots} slots, {dev})")
    print(f"prefix-table entries: {len(eng.snapshot_view())}")


if __name__ == "__main__":
    main()
