"""cpm_tpu_torch: CPM R-CNN in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package `cpm_tpu`, which stays the reference it is held
against. Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels under `csrc/`. The package imports no JAX.
"""
