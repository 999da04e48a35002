"""Registers, shared memory and spills of each kernel in the port's CUDA
sources, as ``nvcc -Xptxas -v`` reports them for sm_90a.

    PYTHONPATH=src python3 -m repro_torch.kernels.resources [name ...]

Needs ``nvcc``; compiles each source into a temporary directory and
prints one line per kernel instantiation (every (query, cache) type pair
and layout).  Nothing runs at import.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels import build


def demangle(names):
    filt = shutil.which("cu++filt") or str(Path(build._nvcc()).parent
                                             / "cu++filt")
    try:
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True, check=True).stdout
        return out.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names


def report(name: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [build._nvcc(), *build.flags(name), "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True).stderr
    kernels, stats = [], []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernels.append(m.group(1))
            stats.append({})
            continue
        if not kernels:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            stats[-1]["spill"] = f"{m.group(1)}/{m.group(2)} B"
        if m := re.search(r"Used (\d+) registers", line):
            stats[-1]["registers"] = m.group(1)
            s = re.search(r"(\d+) bytes smem", line)
            stats[-1]["static smem"] = f"{s.group(1) if s else 0} B"
    for k, st in zip(demangle(kernels), stats):
        k = re.sub(r"\(anonymous namespace\)::|__nv_bfloat16|\((int|bool)\)",
                   lambda x: "bf16" if x.group(0) == "__nv_bfloat16" else "",
                   k)
        print(f"{name}.cu {k.split('(')[0]}: " + ", ".join(
            f"{key} {val}" for key, val in st.items()))


if __name__ == "__main__":
    for n in sys.argv[1:] or build.KERNELS:
        report(n)
