"""Roofline analysis of the port's dry-run records, and of measured steps.

A port of the JAX package's ``repro.launch.roofline``.  The JAX module
re-derives a step's costs from partitioned HLO text (XLA counts a while
loop's body once, so it parses trip counts, and weights zamba's shared
block by a branch factor).  PyTorch has no HLO: the port's dry run
(``launch.dryrun``) executes the step on ``meta`` tensors, so its loops
run their real trip counts, zamba's Python ``if`` takes its real branch
and the shared block is counted exactly where it runs.  Its record's
``cost_analysis`` (FLOPs and bytes a chip) and ``collective_bytes`` (the
spec pass's executed collectives, ``distributed.spmd``) are read here as
they are.

Terms (seconds/step/chip), against one NVIDIA H100 80GB HBM3 (SXM5,
NVIDIA's data sheet, dense rates):
  compute    = flops / 989e12        (bf16 tensor-core peak)
  memory     = bytes / 3.35e12       (HBM3 bandwidth)
  collective = wire bytes / 450e9    (NVLink 4, 18 links, one direction)

``model_params`` / ``model_flops`` are the JAX package's yardstick of
useful work (6ND train, 2ND prefill, 2N decode, plus attention), over
the port's parameter tree with the JAX path names.  :func:`measured`
reads a step timed on the card against that yardstick and the counted
work of the same step.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

PEAK_FLOPS = 989e12          # bf16 dense / chip (H100 SXM5)
HBM_BW = 3.35e12             # bytes/s / chip (HBM3)
NVLINK_BW = 450e9            # bytes/s / chip, one direction (18 x NVLink 4)
CARD = "NVIDIA H100 80GB HBM3"


def card() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is none (the constants then stand alone)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    proc = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else None


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the "useful compute" yardstick)
# ---------------------------------------------------------------------------

def model_params(cfg) -> Tuple[float, float]:
    """(total params, active params) from exact meta-tensor sizes."""
    from repro_torch.distributed.sharding import tree_map_with_path
    from repro_torch.models.registry import param_shapes

    sizes = []
    tree_map_with_path(lambda path, leaf: sizes.append(
        ("/".join(path), leaf.numel())), param_shapes(cfg))
    total = active = 0.0
    for name, numel in sizes:
        n = float(numel)
        if "embed" in name:
            continue                      # 6ND convention: non-embedding
        total += n
        if cfg.moe and re.search(r"moe/(w1|w2|w3)$", name):
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, shape) -> float:
    """Global MODEL_FLOPS per step: 6ND train / 2ND prefill / 2N decode,
    plus causal attention terms."""
    N, N_act = model_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    attn_layers = (
        0 if (cfg.xlstm is not None) else
        (cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every
         else cfg.n_layers)
    )
    if shape.kind == "train":
        flops = 6.0 * N_act * B * S
        flops += 6.0 * attn_layers * B * S * S * cfg.n_heads * hd  # causal/2*12
        if cfg.window and not cfg.encoder_only:
            # local layers attend to <= window keys
            local = attn_layers - (attn_layers // cfg.global_every
                                   if cfg.global_every else 0)
            flops -= 6.0 * local * B * S * max(0, S - cfg.window) \
                * cfg.n_heads * hd
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * N_act * B * S
        flops += 2.0 * attn_layers * B * S * S * cfg.n_heads * hd / 2
        return flops
    # decode: one token/seq; attention reads the S-long cache
    flops = 2.0 * N_act * B
    flops += 4.0 * attn_layers * B * S * cfg.n_heads * hd
    return flops


# ---------------------------------------------------------------------------
# cell -> roofline record
# ---------------------------------------------------------------------------

def terms(flops: float, nbytes: float, wire: float = 0.0) -> Dict:
    """The three roofline times (s) of one chip's work, and the largest."""
    t = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
         "collective": wire / NVLINK_BW}
    return {"t_compute_s": t["compute"], "t_memory_s": t["memory"],
            "t_collective_s": t["collective"],
            "bottleneck": max(t, key=t.get), "step_time_s": max(t.values())}


def analyze_cell(rec: Union[Dict, Path], cfg=None, shape=None) -> Dict:
    """A dry-run record (or its JSON file) -> its roofline record; ``cfg``
    and ``shape`` default to the record's arch and shape by name."""
    from repro_torch.config import SHAPES, get_arch

    if not isinstance(rec, dict):
        rec = json.loads(Path(rec).read_text())
    if rec.get("status") != "OK":
        return rec
    cfg = cfg or get_arch(rec["arch"])
    shape = shape or SHAPES[rec["shape"]]
    chips = rec["n_chips"]
    flops = rec["cost_analysis"]["flops"]
    nbytes = rec["cost_analysis"]["bytes accessed"]
    wire = sum(rec.get("collective_bytes", {}).values())
    t = terms(flops, nbytes, wire)
    mf = rec.get("model_flops") or model_flops(cfg, shape)
    step = t.pop("step_time_s")
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "n_chips")},
        "status": "OK",
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": nbytes,
        "coll_bytes_per_chip": wire,
        **t,
        "model_flops_global": mf,
        "useful_ratio": mf / chips / max(flops, 1.0),
        "roofline_fraction_mfu": (mf / chips / PEAK_FLOPS) / step
        if step else 0.0,
        "temp_bytes": rec.get("memory_analysis", {}).get(
            "temp_size_in_bytes"),
    }


def analyze_all(results_dir: Path, mesh: str = "single") -> List[Dict]:
    return [analyze_cell(p)
            for p in sorted(results_dir.glob(f"*__{mesh}.json"))]


def table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "bottleneck | MODEL/counted | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if r.get("status") != "OK":
            lines.append(
                f"| {r.get('arch','?')} | {r.get('shape','?')} | "
                f"{r.get('mesh','?')} | - | - | - | "
                f"{r.get('status')}: {r.get('reason','')} | - | - |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction_mfu']:.2%} |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# a step measured on the card, read against the roofline
# ---------------------------------------------------------------------------

def measured(cfg, shape, ms: float) -> Dict:
    """A step of ``shape`` (kind, B, S) timed at ``ms`` on one card, read
    against the roofline: ``model_flops`` on a 1 x 1 mesh, the counted
    FLOPs and bytes of the same step (a meta trace, ``dryrun.trace_step``),
    ``mfu`` = model FLOPs / (ms x peak), the counted rates' shares of the
    peak FLOP/s and of the HBM bandwidth, and the larger roofline term."""
    import torch

    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(shape={"data": 1, "model": 1}, axis_names=("data", "model"),
                device=torch.device("meta"))
    tr = trace_step(cfg, shape, mesh, long_context=False)
    mf = model_flops(cfg, shape)
    s = ms / 1e3
    t = terms(tr["flops"], tr["bytes"])
    return {
        "ms": ms,
        "model_flops": mf,
        "counted_flops": tr["flops"],
        "counted_bytes": tr["bytes"],
        "counted_over_model": tr["flops"] / mf,
        "mfu": mf / (s * PEAK_FLOPS),
        "counted_tflops": tr["flops"] / s / 1e12,
        "flops_share": tr["flops"] / s / PEAK_FLOPS,
        "bytes_share": tr["bytes"] / s / HBM_BW,
        "bottleneck": t["bottleneck"],
        "bound_ms": t["step_time_s"] * 1e3,
        "trace_s": tr["lower_s"],
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    rows = analyze_all(Path(args.dir), args.mesh)
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        print(f"constants: {CARD} (SXM5 data sheet: {PEAK_FLOPS:.3e} "
              f"FLOP/s bf16, {HBM_BW:.3e} B/s HBM, {NVLINK_BW:.3e} B/s "
              f"NVLink); card here: {card() or 'none'}")
        print(table(rows))
