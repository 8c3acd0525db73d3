"""CLI trainer of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --reduced --steps 20 --device cpu            # tiny, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert_xlarge \\
      --batch 8 --seq 512 --steps 6              # full width, on cuda

``--device`` defaults to ``cuda`` (raises without a card).  ``--reduced``
trains the smoke-scale config; the full configs need a card.  Every
ported family trains: the decoders, the MoE models and the hybrid
(zamba2) and xLSTM models on tokens, the VLM on tokens and patch
features, the encoder-only model on frame embeddings
(``data.pipeline.make_batch`` draws each family's inputs).
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.config import get_arch
from repro_torch.train.loop import TrainLoopConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M quickstart)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    loop = TrainLoopConfig(
        batch_size=args.batch, seq_len=args.seq, total_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    out = train(cfg, loop, device=args.device)
    print(
        f"done: {out['steps_per_s']:.2f} steps/s, "
        f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}"
    )


if __name__ == "__main__":
    main()
