"""Checkpoints of the port — train states, and store checkpoints (full
saves + delta chains) — in the JAX package's on-disk format:
:class:`manager.CheckpointManager`."""
