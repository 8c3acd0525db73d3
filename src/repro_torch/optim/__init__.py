"""Optimizers of the port: AdamW (``adamw``) and gradient compression
with error feedback (``compression``)."""
