"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``) and their
plain PyTorch twins.  Each ``<k>/<k>.py`` wrapper launches its kernel on
a CUDA tensor and takes the ``<k>/ref.py`` twin on a CPU tensor."""
