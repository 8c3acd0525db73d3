"""olmoe-1b-7b [moe]: 16L d2048 16H MHA, 64 experts top-8 (d_expert 1024),
V50304 — 1B active / 7B total. [arXiv:2409.02060; hf]"""
from repro_torch.config import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304,
        moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
        accum_steps=4,   # activation fit at train_4k (16 GiB HBM)
        rope_theta=10000.0, tie_embeddings=True,
    )
