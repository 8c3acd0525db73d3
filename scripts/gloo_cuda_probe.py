#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives take CUDA tensors, per backend.

    python3 scripts/gloo_cuda_probe.py [--ranks 2] [--iters 50]

Spawns ``--ranks`` gloo processes, all on ``cuda:0``, and then one NCCL
process, and runs each collective the sharded store uses
(``all_reduce`` SUM / MAX, list ``all_gather``, ``all_gather_into_tensor``,
``all_to_all_single``) on int32, int64 and float32 CUDA tensors: whether
the call is taken, whether its answer is right, and its mean ms over
``--iters`` calls at 4,096 elements a rank (host clock around a
synchronised loop).  Prints one JSON line a (backend, collective,
dtype) and exits non-zero when a rank fails.  Needs a card.  Rerun it
after a torch upgrade: ``repro_torch.distributed.collectives`` hands
CUDA tensors to gloo unstaged because every row here was taken.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 4096
DTYPES = {"int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32}


def _ops(n: int):
    """name -> (run(x) -> result, want(xs of every rank) -> result)."""
    def all_reduce(op, ref):
        def run(x):
            y = x.clone()
            dist.all_reduce(y, op=op)
            return y
        return run, ref

    def gather_list(x):
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
        return torch.stack(out)

    def gather_tensor(x):
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out.view((n,) + tuple(x.shape))

    def to_all(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    def want_to_all(xs, r):
        return torch.cat([x.view(n, -1)[r] for x in xs])

    return {
        "all_reduce_sum": all_reduce(dist.ReduceOp.SUM,
                                     lambda xs, r: sum(xs)),
        "all_reduce_max": all_reduce(
            dist.ReduceOp.MAX, lambda xs, r: torch.stack(xs).amax(0)),
        "all_gather": (gather_list, lambda xs, r: torch.stack(xs)),
        "all_gather_into_tensor": (gather_tensor,
                                   lambda xs, r: torch.stack(xs)),
        "all_to_all_single": (to_all, want_to_all),
    }


def _inputs(rank: int, n: int, dtype, dev):
    g = torch.Generator().manual_seed(1000 + rank)
    x = torch.randint(-1000, 1000, (N,), generator=g).to(dtype)
    return x.to(dev), [torch.randint(-1000, 1000, (N,), generator=torch.
                                     Generator().manual_seed(1000 + r))
                       .to(dtype) for r in range(n)]


def _probe(rank: int, n: int, backend: str, init: str, iters: int,
           out_path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=n)
    rows = []
    cuda = torch.device("cuda", 0)
    for name, (run, want) in _ops(n).items():
        for dname, dtype in DTYPES.items():
            x, xs = _inputs(rank, n, dtype, cuda)
            row = dict(backend=backend, ranks=n, op=name, dtype=dname)
            try:
                got = run(x)
                torch.cuda.synchronize()
                row["taken"] = True
                row["right"] = bool(torch.equal(got.cpu(), want(xs, rank)))
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(iters):
                    run(x)
                torch.cuda.synchronize()
                row["ms"] = (time.perf_counter() - t0) * 1e3 / iters
            except (RuntimeError, ValueError, TypeError) as e:
                row["taken"] = False
                row["error"] = str(e).splitlines()[0][:200]
            rows.append(row)
            dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)
    dist.destroy_process_group()


def _spawn(n: int, backend: str, iters: int, tmp: str) -> list:
    out = os.path.join(tmp, f"{backend}.json")
    init = "file://" + os.path.join(tmp, f"{backend}.rdv")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_probe,
                         args=(r, n, backend, init, iters, out))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
    if bad:
        raise RuntimeError(f"{backend}: ranks exited with {bad}")
    with open(out) as f:
        return json.load(f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a card", file=sys.stderr)
        return 1
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          card=torch.cuda.get_device_name(0))))
    with tempfile.TemporaryDirectory() as tmp:
        rows = (_spawn(args.ranks, "gloo", args.iters, tmp)
                + _spawn(1, "nccl", args.iters, tmp))
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
