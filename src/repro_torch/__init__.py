"""repro_torch — the Uruv store ported to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The layout mirrors the JAX package module for module: ``core`` holds the
store, its index and the combining layer, ``kernels`` the CUDA kernels
with their plain PyTorch twins, and ``api`` the ``Uruv`` client.  Every
entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card it raises instead of falling back.
"""
