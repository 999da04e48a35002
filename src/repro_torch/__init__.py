"""PyTorch/CUDA port of the ``repro`` package (Edge-MultiAI serving).

Module paths mirror ``repro`` one for one; the port imports neither JAX
nor anything of ``repro``.  Kernels on the serving path are hand-written
for Hopper (``repro_torch/csrc``); tensors on the CPU take their plain
PyTorch versions.
"""
