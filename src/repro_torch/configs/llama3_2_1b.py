"""llama3.2-1b [dense]: 16L d2048 32H GQA(8) ff8192 V128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=64,
        rope_theta=500000.0, tie_embeddings=True,
    )
