"""qwen3-4b [dense]: 36L d2560 32H GQA(8) ff9728 V151936; qk-norm.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab=151936, head_dim=128,
        rope_theta=1000000.0, qk_norm=True, tie_embeddings=True,
    )
