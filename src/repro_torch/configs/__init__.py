"""Published architecture configs the port runs: the dense decoders
(``llama3_2_1b``, ``qwen3_4b``, ``olmo_1b``, and ``gemma3_1b`` with its
sliding-window local layers), the MoE decoders (``olmoe_1b_7b``;
``deepseek_moe_16b`` with shared experts), the encoder-only audio model
(``hubert_xlarge``), the VLM (``internvl2_76b``, patch features from a
stubbed vision frontend), the hybrid ``zamba2_2_7b`` (a Mamba2 backbone
with one shared attention block) and the recurrent ``xlstm_350m``
(mLSTM and sLSTM blocks), plus the paper's store workload
(``uruv_paper``).  Each model module's ``config()`` returns its
:class:`repro_torch.config.ArchConfig`."""
