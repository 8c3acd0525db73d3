"""zamba2-2.7b [hybrid]: 54L d2560 Mamba2 backbone (state 64) + shared
attention block (32H/kv32) every 6 layers, ff10240 V32000.
[arXiv:2411.15242; hf]"""
from repro_torch.config import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, head_dim=80,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        hybrid_attn_every=6, tie_embeddings=True,
        accum_steps=4,   # activation fit at train_4k (16 GiB HBM)
    )
