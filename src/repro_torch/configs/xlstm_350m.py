"""xlstm-350m [ssm]: 24 blocks d1024, 7:1 mLSTM:sLSTM groups, V50304,
d_ff=0 (in-block projections). [arXiv:2405.04517; unverified]"""
from repro_torch.config import ArchConfig, XLSTMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        xlstm=XLSTMConfig(m_per_group=7, proj_factor=2.0, d_conv=4,
                          head_dim=256),
        tie_embeddings=True,
    )
