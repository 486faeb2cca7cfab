"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports ``torch``
and nothing of ``jax`` or ``repro``. Module names mirror the reference so a
reader can find each counterpart. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` explicitly; on a CUDA tensor every kernel
wrapper launches its hand-written kernel or raises, and on a CPU tensor it
runs the kernel's plain PyTorch version.
"""
