"""Data of the port: the synthetic corpus, batches and the Uruv-backed
streaming sample store (``pipeline``)."""
