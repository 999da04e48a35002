"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor anything of the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

# Every module file of the port, the directories without an __init__
# (distributed, models, quant, launch, training) included.
PROBE = """
import importlib, pathlib, sys
import repro_torch
root = pathlib.Path(repro_torch.__file__).parent
names = []
for path in sorted(root.rglob("*.py")):
    parts = path.relative_to(root.parent).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    importlib.import_module(".".join(parts))
    names.append(".".join(parts))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(" ".join(names))
"""

# The modules of the sharded loader, the elastic mesh and the cluster
# tier; of training, checkpoints and supervised restarts; of the
# distributed remainder (elastic resharding, the sharding context, the
# launch specs and meshes).
SLICE = ("repro_torch.distributed.sharding",
         "repro_torch.distributed.fault_tolerance",
         "repro_torch.serving.sharded_loader", "repro_torch.serving.elastic",
         "repro_torch.cluster", "repro_torch.cluster.config",
         "repro_torch.cluster.routers", "repro_torch.cluster.cluster",
         "repro_torch.training.data", "repro_torch.training.optim",
         "repro_torch.training.pytree", "repro_torch.training.train_step",
         "repro_torch.distributed.checkpoint",
         "repro_torch.distributed.compression",
         "repro_torch.launch.train", "repro_torch.distributed.elastic",
         "repro_torch.distributed.ctx", "repro_torch.launch.specs",
         "repro_torch.launch.mesh")


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    # Every module was imported (kernels, models, serving, cluster...).
    assert len(names) >= 50
    assert set(SLICE) <= set(names)


def test_smoke_and_training_example_import_neither_jax_nor_repro():
    """``chip_smoke.py`` and ``examples/torch_train_small_lm.py`` name no
    JAX module and nothing of the JAX package."""
    import ast

    root = SRC.parent
    for path in (root / "chip_smoke.py",
                 root / "examples" / "torch_train_small_lm.py"):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"jax", "jaxlib", "repro"}, (path, names)
