"""deepseek-moe-16b [moe]: 28L d2048 16H MHA, 2 shared + 64 routed top-6
fine-grained experts (d_expert 1408), V102400. [arXiv:2401.06066; hf]
(Simplification: the released model keeps layer 0 dense; we apply MoE
uniformly for scan-uniformity — FLOP delta < 2%. DESIGN.md Sec 6.)"""
from repro_torch.config import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
        accum_steps=4,   # activation fit at train_4k (16 GiB HBM)
        rope_theta=10000.0, tie_embeddings=True,
    )
