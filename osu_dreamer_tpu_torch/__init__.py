"""PyTorch/CUDA port of osu_dreamer_tpu for NVIDIA Hopper (H100).

The JAX package ``osu_dreamer_tpu`` stays the reference. This package mirrors
its module paths (``nn/norm.py`` <-> ``osu_dreamer_tpu/nn/norm.py`` and so on),
keeps its channel-last (B, L, C) layout at every public function, and imports
neither jax nor the JAX package. Its hot ops are hand-written sm_90a kernels
(``csrc/``), built with nvcc at the first CUDA call; CPU tensors take each
kernel's plain PyTorch version.
"""
