"""The kernel entry points the port's models call.

Dispatch follows the device of the tensors, and nothing else: a tensor on
the CPU is computed by the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, and so is a ``meta`` tensor (shapes and
types only: the launch dry-run, :mod:`repro_torch.launch.dryrun`, runs the
plain graph, as the reference's lowers it, and counts each plain version's
bytes as its kernel's, through :func:`repro_torch.kernels.ref.as_kernel`;
nothing is built or launched);
a CUDA tensor goes to the hand-written Hopper kernel, which raises on an
input it cannot take.  There is no
override and no silent fallback on a GPU.  ``quantize_weights``,
``ssd_step``, ``causal_conv1d`` and ``causal_conv1d_step`` are no kernels
(as in the reference) and run the plain versions on any device;
``paginate_kv`` lays a dense cache out as the pages and table that
``paged_decode_attention`` reads, ``split_plan`` says how the two
decode kernels cut a call's keys, ``flash_plan`` and ``ssd_plan`` how the
prefill attention and the scan cut theirs.  ``flash_attention`` and
``ssd_scan`` are differentiable through autograd Functions on every
device: their backwards are the port's own kernels on the card,
``flash_attention_bwd`` (cut by ``flash_bwd_plan``) and ``ssd_scan_bwd``
(cut by ``ssd_bwd_plan``), and the plain backwards elsewhere; the other
kernels refuse a gradient on the card.
"""
from __future__ import annotations

from repro_torch.kernels import placed, ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention,
                                                  paginate_kv, split_plan)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_bwd_plan, flash_plan)
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.ssd_scan import (ssd_bwd_plan, ssd_plan, ssd_scan,
                                          ssd_scan_bwd)

quantize_weights = ref.quantize_weights
causal_conv1d = ref.causal_conv1d
causal_conv1d_step = ref.causal_conv1d_step



def ssd_step(x, dt, A, Bm, Cm, D, state):
    """The scan's decode step, :func:`repro_torch.kernels.ref.ssd_step`.
    A ``DTensor`` x runs each rank's heads (:mod:`.placed`)."""
    if placed.is_placed(x):
        return placed.ssd_step(ssd_step, x, dt, A, Bm, Cm, D, state)
    return ref.ssd_step(x, dt, A, Bm, Cm, D, state)


__all__ = ["causal_conv1d", "causal_conv1d_step", "decode_attention",
           "flash_attention", "flash_attention_bwd", "flash_bwd_plan",
           "flash_plan", "paged_decode_attention", "paginate_kv",
           "quant_matmul", "quantize_weights", "split_plan", "ssd_bwd_plan",
           "ssd_plan", "ssd_scan", "ssd_scan_bwd", "ssd_step"]
