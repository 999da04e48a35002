"""Tenants placed across ranks (ROADMAP A13, serving): the port's
counterparts of the reference's placement tests, and placed serving
against the reference's unsharded runtime.

Each world size runs once, in a child process that forks its gloo CPU
ranks (``start_processes(..., start_method="fork")``; the ranks meet
through a file under the test's directory, no port), as
``tests/test_torch_distributed.py`` does.  The child runs its jobs and
rank 0 writes what they gave to ``out.npz``; the tests here hold it to the
JAX package, run unsharded in this process on the same numpy inputs:

- 2 and 4 ranks: reduced tinyllama-1.1b, gemma2-2b and mamba2-780m at 32
  and 8 bits through ``TenantRuntime.set_variant``/``generate`` placed on a
  (1, n) mesh, and the placed prefill's logits; 4 ranks put 2 KV heads
  under 4 query heads' ranks (each KV head repeated to its ranks);
- 4 ranks: ``quant_matmul`` on a weight split on K = 384 (groups of 128)
  over 4 ranks, 96 rows a rank, every rank but the first starting
  inside a group;
- 2 ranks: rank 0's ``EdgeServer`` serving 6 requests while rank 1 repeats
  its calls, each request's ids against one process's run; placed builds
  of hymba and olmoe raising at ``start`` (features the placed path
  lacks), reduced granite and yi placed against one process, and a placed
  tree refusing the int8 cache and the deferred decode;
- 8 ranks: per-rank bytes after ``set_variant`` against
  ``weight_shard_fraction`` (``tests/test_elastic_serving.py:286``),
  ``elastic.reshard`` to a layout that changes, and ``place_tree`` of bf16
  params (``tests/test_sharded_loader.py:317``).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.serving.server import TenantRuntime as JTR
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import placed
from repro_torch.kernels import ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("tinyllama-1.1b", "gemma2-2b", "mamba2-780m")
BITS = (32, 8)
MAX_NEW = 8
# Tolerances of tests/test_kernels.py, by the variant's arithmetic.
LOGIT_TOL = {32: dict(rtol=3e-5, atol=3e-5), 8: dict(rtol=2e-4, atol=2e-4)}
QMM = (5, 384, 64, 128)  # M, K, N, group of the row-split quant_matmul

CHILD = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, "src")
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def load_tree(path):
        tree = {}
        for key, a in np.load(path).items():
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(a)
        return tree

    def generate(rank, world, root, mesh, out):
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import whole
        from repro_torch.models import transformer as T
        from repro_torch.serving.server import TenantRuntime

        for arch in ("tinyllama-1.1b", "gemma2-2b", "mamba2-780m"):
            cfg = get_config(arch, reduced=True)
            tr = TenantRuntime(arch, cfg,
                               load_tree(f"{root}/params-{arch}.npz"),
                               precisions=(32, 8), device="cpu")
            tr.attach_mesh(mesh)
            prompts = np.load(f"{root}/prompts-{arch}.npy")
            for bits in (32, 8):
                tr.set_variant(tr.zoo.by_bits(bits))
                with torch.no_grad():
                    logits, _ = T.prefill(
                        cfg, tr.device_params,
                        {"tokens": torch.from_numpy(prompts)},
                        max_len=prompts.shape[1] + 8)
                out[f"logits/{arch}/{bits}"] = whole(logits).numpy()
                out[f"ids/{arch}/{bits}"] = tr.generate(prompts, 8)

    def qmm(rank, world, root, mesh, out):
        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import ops

        a = np.load(f"{root}/qmm.npz")
        x, q, s = (torch.from_numpy(a[k]) for k in ("x", "q", "s"))
        xd = SH.place(x, mesh, (None, "model"))
        qd = SH.place(q, mesh, ("model", None))
        sd = SH.place(s, mesh, (None, None))
        y = ops.quant_matmul(xd, qd, sd, out_dtype=torch.float32)
        out["qmm/placements"] = np.array(str(y.placements))
        out["qmm/y"] = SH.whole(y).numpy()

    def server(rank, world, root, mesh, out):
        from repro_torch.serving import api
        from repro_torch.serving.server import EdgeServer, _generate_tokens

        names = ("tinyllama-1.1b", "mamba2-780m", "gemma2-2b")
        # A config with a feature the placed path lacks refuses a placed
        # build: hymba's hybrid blocks and meta tokens, olmoe's experts.
        for key, arch in (("family", "hymba-1.5b"), ("moe", "olmoe-1b-7b")):
            try:
                EdgeServer.build(api.ServingConfig(
                    tenants=(api.TenantSpec(arch),),
                    loader=api.LoaderSpec(sharded=True,
                                          mesh_shape=(world,))),
                    device="cpu")
                out[key] = np.array("")
            except NotImplementedError as e:
                out[key] = np.array(str(e))
        srv = EdgeServer.build(api.ServingConfig(
            tenants=tuple(api.TenantSpec(n) for n in names),
            loader=api.LoaderSpec(sharded=True, mesh_shape=(world,)),
            kv_headroom_shape=(2, 14)), device="cpu")
        if srv.is_worker:
            srv.run_worker()
            return
        rng = np.random.default_rng(7)
        for i in range(6):
            app = names[i % 3]
            tr = srv.tenants[app]
            prompts = rng.integers(0, tr.cfg.vocab_size,
                                   (2, 4 + i)).astype(np.int32)
            r = srv.serve(app, prompts, max_new=6, now_ms=1500.0 * i)
            out[f"served/{i}/placed"] = np.array(
                type(tr.device_params["final_norm"]).__name__)
            out[f"served/{i}/failed"] = np.array(r.failed)
            out[f"served/{i}/ids"] = r.tokens
            out[f"served/{i}/one"] = _generate_tokens(
                tr.cfg, tr.host[r.bits], torch.from_numpy(prompts),
                max_new=6, max_len=prompts.shape[1] + 6).numpy()
        srv.close()

    def dense(rank, world, root, mesh, out):
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import transformer as T
        from repro_torch.serving.server import (TenantRuntime,
                                                _generate_tokens)

        # Dense families outside the main path's three, placed because
        # their configs need nothing the placed path lacks.
        for arch in ("granite-3-2b", "yi-6b"):
            cfg = get_config(arch, reduced=True)
            params = T.init_params(cfg, 5, torch.float32, device="cpu")
            tr = TenantRuntime(arch, cfg, params, precisions=(32,),
                               device="cpu")
            tr.attach_mesh(mesh)
            tr.set_variant(tr.zoo.by_bits(32))
            prompts = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab_size, (2, 7)).astype(np.int32))
            with torch.no_grad():
                logits, _ = T.prefill(cfg, tr.device_params,
                                      {"tokens": prompts}, max_len=13)
                one, _ = T.prefill(cfg, tr.host[32], {"tokens": prompts},
                                   max_len=13)
            out[f"dense/{arch}/placed"] = np.array(
                type(tr.device_params["final_norm"]).__name__)
            out[f"dense/{arch}/logits"] = SH.whole(logits).numpy()
            out[f"dense/{arch}/one_logits"] = one.numpy()
            out[f"dense/{arch}/ids"] = tr.generate(prompts.numpy(), 6)
            out[f"dense/{arch}/one_ids"] = _generate_tokens(
                cfg, tr.host[32], prompts, max_new=6, max_len=13).numpy()

    def placement(rank, world, root, mesh, out):
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import transformer as T
        from repro_torch.serving.server import TenantRuntime

        cfg = get_config("tinyllama-1.1b", reduced=True)
        params = T.init_params(cfg, 0, torch.float32, device="cpu")
        tr = TenantRuntime("tinyllama-1.1b", cfg, params,
                           precisions=(16, 8), device="cpu")
        tr.attach_mesh(mesh)
        for bits in (16, 8):
            tr.set_variant(tr.zoo.by_bits(bits))
            out[f"bytes/{bits}"] = np.array(
                [b for b, _ in tr.rank_bytes()])
            out[f"total/{bits}"] = np.array(
                SH.local_nbytes(tr.host[bits]))
        tr.reshard_device_params()  # recovery path: same mesh, still placed
        leaf = tr.device_params["layers"]["wq"]["q"]
        out["reshard/placements"] = np.array(str(leaf.placements))
        out["reshard/bytes"] = np.array([b for b, _ in tr.rank_bytes()])
        # A layout that does change: every leaf gathered whole (the
        # group's all-gather), then split again by the partition rules.
        from repro_torch.distributed.elastic import reshard
        from repro_torch.training import pytree
        specs = tr._spec_tree(8)
        whole = reshard(tr.device_params, SH.spec_map(
            lambda s: (None,) * len(s), specs), mesh)
        out["reshard/whole_equal"] = np.array(all(
            torch.equal(a.to_local(), b) for a, b in zip(
                pytree.leaves(whole), pytree.leaves(tr.host[8]))))
        again = reshard(whole, specs, mesh)
        out["reshard/again_bytes"] = np.array(
            SH.rank_nbytes(again))
        bf16 = {k: v.to(torch.bfloat16) for k, v in params.items()
                if not isinstance(v, dict)}
        bf16["layers"] = {k: v.to(torch.bfloat16)
                          for k, v in params["layers"].items()}
        specs = SH.param_specs(cfg, bf16, SH.logical(mesh), fsdp=False)
        placed = SH.place_tree(bf16, mesh, specs)
        out["loader/bytes"] = np.array(SH.rank_nbytes(placed))
        out["loader/total"] = np.array(SH.local_nbytes(bf16))

    def refuse(rank, world, root, mesh, out):
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import transformer as T

        cfg = get_config("tinyllama-1.1b", reduced=True)
        params = T.init_params(cfg, 0, torch.float32, device="cpu")
        placed = SH.place_tree(params, mesh, SH.param_specs(
            cfg, params, SH.logical(mesh), fsdp=False))
        tokens = torch.zeros((2, 3), dtype=torch.int32)
        for name, call in (
                ("int8", lambda: T.prefill(cfg, placed, {"tokens": tokens},
                                           max_len=6, quantize_cache=True)),
                ("deferred", lambda: T.decode_step(
                    cfg, placed, T.init_cache(cfg, 2, 6), tokens[:, 0],
                    uniform_pos=True))):
            try:
                call()
                out[f"refuse/{name}"] = np.array("")
            except NotImplementedError as e:
                out[f"refuse/{name}"] = np.array(str(e))

    JOBS = {"generate": generate, "qmm": qmm, "server": server,
            "dense": dense, "placement": placement, "refuse": refuse}

    def refuse(*a, **k):
        raise RuntimeError("a functional collective other than all_reduce "
                           "on the placed path")

    def run(rank, root, world, jobs):
        import torch.distributed._functional_collectives as fc
        from repro_torch.launch.mesh import make_mesh

        # Every gather of the placed path is the process group's own (the
        # functional all-gather crashes on gloo with CUDA tensors).
        for name in ("all_gather_tensor", "all_gather_tensor_autograd",
                     "all_gather_single", "reduce_scatter_tensor",
                     "all_to_all_single", "all_to_all_single_autograd"):
            setattr(fc, name, refuse)
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                                rank=rank, world_size=world)
        mesh = make_mesh((world,), ("model",), "cpu")
        out = {}
        for job in jobs:
            JOBS[job](rank, world, root, mesh, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        root, world, jobs = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
        mp.start_processes(run, args=(root, world, jobs), nprocs=world,
                           start_method="fork")
""")


def _np(tree, prefix=""):
    """A reference tree as {"a/b": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_np(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _jcfg_params(arch):
    cfg = jget(arch, reduced=True)
    return cfg, JT.init_params(cfg, jax.random.key(ARCHS.index(arch) + 3),
                               jnp.float32)


def _prompts(arch):
    """Numpy-seeded prompts; gemma2's run past its 8-token window."""
    cfg = jget(arch, reduced=True)
    S = 12 if arch == "gemma2-2b" else 7
    return np.random.default_rng(ARCHS.index(arch)).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)


def _spawn(tmp, world: int, *jobs: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp), str(world), *jobs],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's params and prompts, written for the children."""
    root = tmp_path_factory.mktemp("inputs")
    for arch in ARCHS:
        np.savez(root / f"params-{arch}.npz", **_np(_jcfg_params(arch)[1]))
        np.save(root / f"prompts-{arch}.npy", _prompts(arch))
    M, K, N, group = QMM
    rng = np.random.default_rng(11)
    q, s = ref.quantize_weights(
        torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)),
        bits=8, group=group)
    np.savez(root / "qmm.npz", x=rng.standard_normal((M, K)).astype(
        np.float32), q=q.numpy(), s=s.numpy())
    return root


@pytest.fixture(scope="module")
def placed_runs(inputs, tmp_path_factory):
    """{world: out.npz of its child}: 2 ranks (generate, the server), 4
    (generate, the row-split quant_matmul), 8 (placement)."""
    out = {}
    for world, jobs in ((2, ("generate", "server", "dense", "refuse")),
                        (4, ("generate", "qmm")),
                        (8, ("placement",))):
        root = tmp_path_factory.mktemp(f"world{world}")
        for f in inputs.iterdir():
            os.symlink(f, root / f.name)
        out[world] = _spawn(root, world, *jobs)
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's unsharded ``TenantRuntime``: prefill logits and
    greedy ids of each arch and variant."""
    out = {}
    for arch in ARCHS:
        cfg, params = _jcfg_params(arch)
        tr = JTR(arch, cfg, params, precisions=BITS)
        prompts = _prompts(arch)
        for bits in BITS:
            tr.set_variant(tr.zoo.by_bits(bits))
            logits, _ = JT.prefill(cfg, tr.device_params,
                                   {"tokens": jnp.asarray(prompts)},
                                   max_len=prompts.shape[1] + MAX_NEW)
            out[arch, bits] = (np.asarray(logits),
                               tr.generate(prompts, MAX_NEW))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_generate_matches_reference(placed_runs, reference, arch,
                                           bits, world):
    """The port placed on a (1, world) mesh against the reference's
    unsharded runtime: greedy ids exact, prefill logits at the variant's
    tolerance."""
    want_logits, want_ids = reference[arch, bits]
    got = placed_runs[world]
    np.testing.assert_array_equal(got[f"ids/{arch}/{bits}"], want_ids)
    np.testing.assert_allclose(got[f"logits/{arch}/{bits}"], want_logits,
                               **LOGIT_TOL[bits])


def test_row_split_quant_matmul_starting_mid_group(placed_runs, inputs):
    """K = 384 in groups of 128 over 4 ranks: 96 rows a rank, ranks 1-3
    starting inside a group.  Each rank's product on its rows, summed,
    against the unsharded product."""
    got = placed_runs[4]
    with np.load(inputs / "qmm.npz") as f:
        x, q, s = (torch.from_numpy(f[k]) for k in ("x", "q", "s"))
    want = ref.quant_matmul(x, q, s).numpy()
    assert "Partial" not in str(got["qmm/placements"])
    np.testing.assert_allclose(got["qmm/y"], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("K,group,ranks", [
    (384, 128, 4), (5632, 128, 8), (64, 32, 4), (256, 128, 2),
    (96, 32, 3)])
def test_shard_scales_regroup_a_rank_block(K, group, ranks):
    """Each rank's scales, regrouped at gcd(group, first row, rows), give
    every row of its block the scale of the group the row lies in; the
    rank's plain product summed over the ranks equals the whole one."""
    N, M = 24, 3
    g = torch.Generator().manual_seed(K + ranks)
    q, s = ref.quantize_weights(torch.randn(K, N, generator=g), bits=8,
                                group=group)
    x = torch.randn(M, K, generator=g)
    rows = K // ranks
    y = 0
    for r in range(ranks):
        lo = r * rows
        sr = placed.shard_scales(s, K, lo, rows)
        per_row = sr.repeat_interleave(rows // sr.shape[0], 0)
        torch.testing.assert_close(
            per_row, s[torch.arange(lo, lo + rows) // group], rtol=0,
            atol=0)
        y = y + ref.quant_matmul(x[:, lo:lo + rows], q[lo:lo + rows], sr)
    torch.testing.assert_close(y, ref.quant_matmul(x, q, s), rtol=2e-4,
                               atol=2e-4)


def test_placed_server_serves_as_one_process(placed_runs):
    """Rank 0's engine serves 6 requests over three tenants placed on 2
    ranks (rank 1 repeats its calls): every request served from
    ``DTensor`` leaves, its ids those of one process's run."""
    got = placed_runs[2]
    for i in range(6):
        assert str(got[f"served/{i}/placed"]) == "DTensor"
        assert not bool(got[f"served/{i}/failed"])
        np.testing.assert_array_equal(got[f"served/{i}/ids"],
                                      got[f"served/{i}/one"])


def test_placed_build_of_another_family_raises(placed_runs):
    msg = str(placed_runs[2]["family"])
    assert "hymba-1.5b" in msg and "ROADMAP A13" in msg
    assert "hybrid blocks" in msg and "meta tokens" in msg


def test_placed_build_of_a_moe_family_raises(placed_runs):
    """olmoe's experts are not placed: its build raises at ``start``,
    naming the feature, before any rank builds a group."""
    msg = str(placed_runs[2]["moe"])
    assert "olmoe-1b-7b" in msg and "8 experts" in msg
    assert "ROADMAP A13" in msg


@pytest.mark.parametrize("arch", ["granite-3-2b", "yi-6b"])
def test_other_dense_families_serve_placed(placed_runs, arch):
    """A dense family outside the main path's three is placed on 2 ranks
    by what its config uses, not by its name: prefill logits and greedy
    ids those of one process on the same weights."""
    got = placed_runs[2]
    assert str(got[f"dense/{arch}/placed"]) == "DTensor"
    np.testing.assert_allclose(got[f"dense/{arch}/logits"],
                               got[f"dense/{arch}/one_logits"],
                               **LOGIT_TOL[32])
    np.testing.assert_array_equal(got[f"dense/{arch}/ids"],
                                  got[f"dense/{arch}/one_ids"])


GAPS = {  # arch -> {model axis size: features its placed build lacks}
    "tinyllama-1.1b": {2: [], 8: []},
    "gemma2-2b": {2: [], 8: []},
    "mamba2-780m": {2: [], 8: []},
    "yi-6b": {2: [], 8: []},
    "granite-3-2b": {2: [], 8: []},
    "hymba-1.5b": {2: ["128 meta tokens", "hybrid blocks",
                       "25 query heads over 2 ranks",
                       "5 KV heads over 2 ranks",
                       "25 scan heads over 2 ranks"]},
    "olmoe-1b-7b": {2: ["64 experts"]},
    "llama4-scout-17b-a16e": {2: ["16 experts"]},
    "musicgen-large": {2: ["4 codebooks", "the audio_stub frontend"]},
    "internvl2-1b": {2: ["the vision_stub frontend"],
                     4: ["the vision_stub frontend",
                         "14 query heads over 4 ranks"]},
}


@pytest.mark.parametrize("arch,m,gaps", [
    (a, m, g) for a, by in GAPS.items() for m, g in by.items()])
def test_placement_gaps_follow_the_config(arch, m, gaps):
    """What refuses a placed build is read off the full config's features
    and head counts; the name plays no part (a renamed config refuses or
    places alike)."""
    import dataclasses

    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    assert T.placement_gaps(cfg, m) == gaps
    renamed = dataclasses.replace(cfg, name="renamed")
    assert T.placement_gaps(renamed, m) == gaps
    if gaps:
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            T.check_placeable(renamed, m)
    else:
        T.check_placeable(renamed, m)


@pytest.mark.parametrize("layout", ["int8", "deferred"])
def test_placed_tree_refuses_the_cache_layouts_it_lacks(placed_runs,
                                                        layout):
    """The int8 KV cache and the deferred (``uniform_pos``) decode are not
    placed: a placed tree raises on every rank before any collective."""
    assert "ROADMAP A13" in str(placed_runs[2][f"refuse/{layout}"])


@pytest.mark.parametrize("bits", [16, 8])
def test_set_variant_places_real_shards_matching_ledger_fractions(
        placed_runs, bits):
    """``tests/test_elastic_serving.py:286`` on 8 gloo ranks: the bytes
    each rank holds after ``set_variant`` over the variant's, at the
    ledger's ``weight_shard_fraction`` within 6% (the quantized trees'
    replicated scales), and still placed after
    ``reshard_device_params``."""
    got = placed_runs[8]
    frac = SH.weight_shard_fraction(
        get_config("tinyllama-1.1b", reduced=True),
        SH.LogicalMesh({"data": 1, "model": 8}))
    total = int(got[f"total/{bits}"])
    per_rank = got[f"bytes/{bits}"]
    assert len(per_rank) == 8 and total > 0
    for nbytes in per_rank:
        assert nbytes / total == pytest.approx(frac, rel=0.06), (
            bits, nbytes, total)
    assert "Shard" in str(got["reshard/placements"])
    np.testing.assert_array_equal(got["reshard/bytes"], got["bytes/8"])


def test_reshard_moves_a_changed_layout_through_the_group(placed_runs):
    """``elastic.reshard`` of a placed variant to a layout that differs:
    gathered whole on every rank (equal to the host tree; the children
    refuse the functional all-gather), then split by the partition rules
    again, each rank back at its bytes after ``set_variant``."""
    got = placed_runs[8]
    assert bool(got["reshard/whole_equal"])
    np.testing.assert_array_equal(got["reshard/again_bytes"], got["bytes/8"])


def test_real_mesh_placement_matches_ledger_fractions(placed_runs):
    """``tests/test_sharded_loader.py:317`` on 8 gloo ranks: bf16 params
    placed by the partition rules, each rank's bytes at
    ``weight_shard_fraction`` to 1e-6 (the reference's, too)."""
    got = placed_runs[8]
    total = int(got["loader/total"])
    frac = SH.weight_shard_fraction(
        get_config("tinyllama-1.1b", reduced=True),
        SH.LogicalMesh({"data": 1, "model": 8}))
    jfrac = JSH.weight_shard_fraction(
        jget("tinyllama-1.1b", reduced=True),
        JSH.LogicalMesh({"data": 1, "model": 8}))
    assert frac == jfrac
    for nbytes in got["loader/bytes"]:
        assert nbytes / total == pytest.approx(frac, rel=1e-6)
