"""ctrlora_tpu_torch: the PyTorch/CUDA port of ctrlora_tpu for NVIDIA Hopper.

The JAX package ``ctrlora_tpu`` is the reference this package is held
against. This package imports torch and numpy only; its kernels
(``ops/``) are written by hand for sm_90a in CUDA C++ (``csrc/``), built
with nvcc at first use.
"""
