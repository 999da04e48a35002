"""Model-zoo builders: the int8/int4 (and bf16) variants of a parameter tree.

Port of :mod:`repro.quant.quantize`.  A parameter tree is a nested dict of
tensors keyed like the reference's pytree (``embed``, ``layers/<name>``
with a leading L dim, ``final_norm``, ``head``), so the same leaves are
quantized.  A quantized weight is ``{"q": int8 (..., K, N), "s": f32
(..., K//group, N)}``; dense layers route it through the fused dequant
kernel (``ops.quant_matmul``) at serve time.

1-D parameters (norms, biases, ...) and embedding tables stay in the base
dtype, as in the reference.  :func:`fidelity` is the zoo's accuracy proxy:
a variant's top-1 agreement and logit MSE against the reference weights.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from repro_torch.kernels import ops

PyTree = Any

# Tree paths containing these substrings are never quantized.  Depthwise
# conv taps are W×C (a few KB) — not worth the fidelity cost.
_EXCLUDE = ("embed", "meta", "final_norm", "conv")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def tree_map(fn: Callable, tree: PyTree, path: str = "") -> PyTree:
    """Apply ``fn(path, tensor)`` to every tensor of a nested dict; paths
    join keys with ``/`` as the reference's ``_path_str`` does."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _quantize_leaf(w: torch.Tensor, bits: int, group: int):
    """Quantize every trailing-2D slice of an >=2-D weight."""
    q, s = ops.quantize_weights(w, bits=bits, group=group)
    return {"q": q, "s": s}


def dequantize_leaf(leaf) -> torch.Tensor:
    if not is_quantized(leaf):
        return leaf
    q, s = leaf["q"], leaf["s"]
    *lead, K, N = q.shape
    G = s.shape[-2]
    group = K // G
    w = q.float().reshape(*lead, G, group, N) * s[..., None, :]
    return w.reshape(*lead, K, N)


def quantize_params(params: PyTree, *, bits: int = 8,
                    group: int = 128) -> PyTree:
    """Return the ``bits``-precision zoo variant of a parameter tree."""
    if bits >= 16:
        dtype = torch.bfloat16 if bits == 16 else torch.float32
        return tree_map(
            lambda _, w: w.to(dtype) if w.ndim >= 2 else w, params)

    def visit(path, w):
        if any(e in path for e in _EXCLUDE):
            return w
        # Leaves under layers/ carry a stacked leading L dim: true weight
        # matrices there are ndim>=3; elsewhere (head) ndim>=2.
        min_ndim = 3 if path.startswith("layers") else 2
        if w.ndim < min_ndim:
            return w
        K = w.shape[-2]
        g = group if K % group == 0 else K
        return _quantize_leaf(w, bits, g)

    return tree_map(visit, params)


def dequantize_params(qparams: PyTree) -> PyTree:
    if is_quantized(qparams):
        return dequantize_leaf(qparams)
    if isinstance(qparams, dict):
        return {k: dequantize_params(v) for k, v in qparams.items()}
    return qparams


def params_nbytes(params: PyTree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(params))


# ---------------------------------------------------------------------------
# Fidelity: the accuracy proxy for LM-arch zoos (the paper's accuracy axis).
# ---------------------------------------------------------------------------
def fidelity(cfg, params_ref: PyTree, qparams: PyTree, batch: dict,
             forward_fn) -> Dict[str, float]:
    """Top-1 agreement (in %) and logit MSE of ``forward_fn`` on the
    dequantized ``qparams`` against ``params_ref``, on the same batch."""
    ref_logits = forward_fn(cfg, params_ref, batch)
    q_logits = forward_fn(cfg, dequantize_params(qparams), batch)
    agree = (ref_logits.argmax(-1) == q_logits.argmax(-1)).float().mean()
    mse = ((ref_logits - q_logits) ** 2).mean()
    return {"top1_agreement": float(agree) * 100.0, "logit_mse": float(mse)}
