"""The benchmark's plain reference: a frozen copy of the port's plain PyTorch.

These modules are copies of what the benchmark's configurations build of
`cpm_tpu_torch`: its config, data transforms and loaders, the ResNet and
ResNeXt trunk with its deformable convs, the FPN, the RPN, the grid-cascade
head, its ops and losses, the optimizer and a one-process train step. Every
import points here and every hand-written kernel is replaced by its plain
PyTorch version: the pooler pools through `ops/roi_align.py`'s gather, the
deformable conv samples through `deform_sample_plain`, and the loaders
decode with PIL. A configuration that builds more (another neck or head,
data parallelism) copies it here as new files. It imports nothing of the port and nothing of JAX, and
runs in float32 (TF32 off, which the benchmark sets). `precision.py` holds
the control's lower precision.
"""
