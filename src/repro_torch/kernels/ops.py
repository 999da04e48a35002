"""The kernel entry points the port's models call.

Dispatch follows the device of the tensors, and nothing else: a tensor on
the CPU is computed by the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the hand-written
Hopper kernel, which raises on an input it cannot take.  There is no
override and no silent fallback on a GPU.  ``quantize_weights`` is no
kernel (as in the reference) and runs the plain version on any device.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul import quant_matmul

quantize_weights = ref.quantize_weights

__all__ = ["decode_attention", "flash_attention", "quant_matmul",
           "quantize_weights"]
