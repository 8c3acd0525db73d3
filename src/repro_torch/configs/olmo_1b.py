"""olmo-1b [dense]: 16L d2048 16H MHA ff8192 V50304; non-parametric LN.
[arXiv:2402.00838; hf]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, norm="layernorm_np",
        rope_theta=10000.0, tie_embeddings=True,
    )
