"""Config system of the port: architecture configs, input shapes, runtime
options — a copy of the JAX package's ``config.py``.

Every architecture the port runs has a module in ``repro_torch.configs``
exposing ``config() -> ArchConfig`` with the exact published hyper-parameters, plus
``ArchConfig.reduced()`` for CPU smoke tests.  Shapes below are the
input-shape set of the dry run (``launch.dryrun``); applicability rules
(decode for encoder-only, long-context for full-attention archs) live in
``shape_applicable``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    d_expert: int             # per-expert FFN hidden size
    n_shared: int = 0         # always-on shared experts (deepseek-moe)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # layers are grouped [m, m, ..., m, s] with group_size = m_per_group + 1
    m_per_group: int = 7      # 7:1 mLSTM:sLSTM (paper's xLSTM[7:1])
    proj_factor: float = 2.0  # mLSTM up-projection
    d_conv: int = 4
    head_dim: int = 256


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    patch_dim: int = 3200     # InternViT-6B feature dim (stubbed frontend)
    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    # attention flavour
    rope_theta: float = 500000.0
    qk_norm: bool = False
    window: int = 0                  # sliding-window size (0 = full)
    global_every: int = 0            # gemma3: every k-th layer is global
    norm: str = "rmsnorm"            # rmsnorm | layernorm_np (olmo)
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = True
    encoder_only: bool = False       # hubert
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    vlm: Optional[VLMConfig] = None
    hybrid_attn_every: int = 0       # zamba2 shared attention period
    # runtime
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    accum_steps: int = 1             # grad-accum microbatches inside a step
    sequence_parallel: bool = True   # shard residual stream seq over model axis
    use_pallas: bool = False         # kept for layout parity; the port always
                                     # takes its kernels on a CUDA tensor

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_moe = (
            dataclasses.replace(self.moe, n_experts=4, top_k=2, d_expert=32,
                                n_shared=min(self.moe.n_shared, 1))
            if self.moe else None
        )
        small_ssm = (
            dataclasses.replace(self.ssm, d_state=8, head_dim=8, chunk=16)
            if self.ssm else None
        )
        small_xl = (
            dataclasses.replace(self.xlstm, m_per_group=3, head_dim=16)
            if self.xlstm else None
        )
        small_vlm = (
            dataclasses.replace(self.vlm, patch_dim=24, n_patches=4)
            if self.vlm else None
        )
        if self.xlstm is not None:
            n_layers = 4  # one group of (3 mLSTM + 1 sLSTM)
        elif self.hybrid_attn_every:
            n_layers = 4
        else:
            n_layers = 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=32,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=8,
            d_ff=64 if self.d_ff else 0,
            vocab=128,
            window=min(self.window, 8) if self.window else 0,
            moe=small_moe,
            ssm=small_ssm,
            xlstm=small_xl,
            vlm=small_vlm,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            accum_steps=1,
            param_dtype="float32",
            compute_dtype="float32",
        )


# ---------------------------------------------------------------------------
# input shapes (assigned): seq_len x global_batch, and which step they lower
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "llama3_2_1b",
    "qwen3_4b",
    "olmo_1b",
    "gemma3_1b",
    "internvl2_76b",
    "zamba2_2_7b",
    "hubert_xlarge",
    "olmoe_1b_7b",
    "deepseek_moe_16b",
    "xlstm_350m",
]


def get_arch(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.config()


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not): the JAX package's skip rules, word for
    word."""
    if arch.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (
            arch.ssm is not None
            or arch.xlstm is not None
            or (arch.window > 0)  # local attention (gemma3 5:1) caps the window
        )
        if not sub_quadratic:
            return False, "pure full-attention arch: 500k needs sub-quadratic attention"
    return True, ""
