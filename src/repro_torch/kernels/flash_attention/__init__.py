"""Prefill attention: the hand-written CUDA kernel (``flash_attention``),
its plain twin (``ref.attention_ref``) and the model-facing ``ops``."""
