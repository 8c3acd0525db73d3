"""hubert-xlarge [audio]: 48L d1280 16H MHA ff5120, 504 cluster classes;
encoder-only, conv waveform frontend stubbed (frame embeddings provided).
[arXiv:2106.07447; unverified]"""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504, encoder_only=True,
        norm="rmsnorm", act="gelu", tie_embeddings=False,
        rope_theta=10000.0,
    )
