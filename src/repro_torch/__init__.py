"""PyTorch/CUDA port of the ``repro`` package.

Mirrors ``repro``'s layout module for module (``repro_torch/core/ising.py``
is the counterpart of ``repro/core/ising.py``).  The JAX package stays the
reference the port is held against; the port imports nothing of it.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
functions that take tensors run where their tensors live.  Every TPU kernel
on the ported path has a hand-written CUDA counterpart under ``csrc/``,
built with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`), with a
plain PyTorch version beside it that CPU tensors take.
"""
