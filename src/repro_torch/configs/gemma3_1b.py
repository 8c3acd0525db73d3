"""gemma3-1b [dense]: 26L d1152 4H GQA(1) ff6912 V262144; 5:1 local:global
sliding window (W=1024), gelu, qk-norm, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        d_ff=6912, vocab=262144, head_dim=256,
        rope_theta=1000000.0, qk_norm=True, act="gelu",
        window=1024, global_every=6, tie_embeddings=True,
    )
