"""Published architecture configs the port serves: the dense decoders
(``llama3_2_1b``, ``qwen3_4b``, ``olmo_1b``, and ``gemma3_1b`` with its
sliding-window local layers), plus the paper's store workload
(``uruv_paper``).  Each model module's ``config()`` returns its
:class:`repro_torch.config.ArchConfig`."""
