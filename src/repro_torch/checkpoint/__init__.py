"""Store checkpoints of the port (full saves + delta chains), in the JAX
package's on-disk format: :class:`manager.CheckpointManager`."""
