"""Model-zoo fidelity explorer on the PyTorch port: what the paper's Table
I/II trade-off looks like on real LM weights (the port of
``examples/zoo_fidelity.py``).

For each selected architecture (reduced config), builds the bf16/int8/int4
zoo, measures size and top-1 agreement against the fp32 weights, and
times load (host -> ``--device``) against inference, demonstrating the
load >> infer asymmetry that makes warm starts matter.  Models run on
``--device``: the card unless the CPU is asked for.

    PYTHONPATH=src python examples/torch_zoo_fidelity.py --archs tinyllama-1.1b olmoe-1b-7b
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.quant.quantize import fidelity, params_nbytes, quantize_params
from repro_torch.serving.server import resolve_device
from repro_torch.training import pytree

ap = argparse.ArgumentParser()
ap.add_argument("--archs", nargs="+",
                default=["tinyllama-1.1b", "mamba2-780m", "olmoe-1b-7b"])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = resolve_device(args.device)


def fwd(c, p, b):
    return T.forward(c, p, b)[..., 0, :]


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def run(arch):
    cfg = get_config(arch, reduced=True)
    g = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, 0, torch.float32, device="cpu")
    shape = ((2, 32) if cfg.num_codebooks == 1
             else (2, 32, cfg.num_codebooks))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                     dtype=torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.num_vision_tokens, cfg.d_model), generator=g)
    batch = {k: v.to(device) for k, v in batch.items()}
    params_dev = pytree.tree_map(lambda t: t.to(device), params)
    base_bytes = params_nbytes(params)
    print(f"\n=== {arch} ({cfg.param_count():,} params, "
          f"fp32={base_bytes / 2 ** 20:.2f}MB)")
    for bits in (16, 8, 4):
        host = quantize_params(params, bits=bits, group=32)  # on the host
        nbytes = params_nbytes(host)
        t0 = time.perf_counter()
        dev = pytree.tree_map(lambda t: t.to(device, copy=True), host)
        sync()
        load_ms = (time.perf_counter() - t0) * 1e3
        fwd(cfg, dev, batch)  # first call: kernels built and warmed
        sync()
        t0 = time.perf_counter()
        fwd(cfg, dev, batch)
        sync()
        infer_ms = (time.perf_counter() - t0) * 1e3
        fid = (dict(top1_agreement=100.0, logit_mse=0.0) if bits == 16
               else fidelity(cfg, params_dev, dev, batch, fwd))
        print(f"  int{bits:<2} size={nbytes / base_bytes:5.2f}x "
              f"agree={fid['top1_agreement']:5.1f}% "
              f"load={load_ms:6.1f}ms infer={infer_ms:6.1f}ms")


for arch in args.archs:
    run(arch)
