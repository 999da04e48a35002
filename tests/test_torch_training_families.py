"""Training on the port against the JAX package's, on the CPU: the SSM,
hybrid and MoE families (mamba2-780m, hymba-1.5b, olmoe-1b-7b,
llama4-scout), by the checks and tolerances of ``test_torch_training.py``.
On the CPU the SSM branch trains through the plain ``ssd_scan``, which
autograd differentiates; on the card through the scan's backward kernel
(``test_torch_train_cuda.py``, ``chip_smoke.py`` phase 10).
"""
import pytest

from test_torch_training import (check_grads, check_loss, check_remat,
                                 check_smoke, check_step)

FAMILIES = ["mamba2-780m", "hymba-1.5b", "olmoe-1b-7b",
            "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_and_train_step(arch):
    check_smoke(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_grads_equal_plain(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kw", [{}, dict(grad_accum=2),
                                dict(compression=True)],
                         ids=["step", "grad_accum", "compression"])
def test_train_step_matches_reference(arch, kw):
    check_step(arch, **kw)
