"""Decode attention: the hand-written CUDA kernel (``decode_attention``),
its plain twin (``ref.decode_attention_ref``) and the model-facing
``ops``."""
