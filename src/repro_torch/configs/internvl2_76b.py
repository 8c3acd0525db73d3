"""internvl2-76b [vlm]: InternViT (stub frontend) + 80L d8192 64H GQA(8)
ff28672 V128256 LM backbone. [arXiv:2404.16821; unverified]"""
from repro_torch.config import ArchConfig, VLMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256, head_dim=128,
        rope_theta=500000.0, tie_embeddings=False,
        vlm=VLMConfig(patch_dim=3200, n_patches=256),
        accum_steps=4,   # 76B activations need microbatching at train_4k
    )
