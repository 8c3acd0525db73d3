"""Published architecture configs the port serves: the dense, window-free
ones (``llama3_2_1b``, ``qwen3_4b``, ``olmo_1b``).  Each module's
``config()`` returns its :class:`repro_torch.config.ArchConfig`."""
