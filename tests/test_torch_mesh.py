"""The port's sharded steps, expert parallelism and checkpoints on real gloo ranks.

Each test starts its ranks as processes (``spawn``) that meet through a file
in the test's ``tmp_path`` (no fixed port, so parallel test workers cannot
collide), builds a ``DeviceMesh`` over them and runs under a timeout of its
own. On a (2, 2) mesh, and once more on the reference's (2, 4):

- reduced qwen2 (dense), qwen2-moe and mamba2 (ssm) at f32:
  ``build_train_step(mesh=)`` gives three steps' metrics within 1e-5
  relative of the unsharded port step (itself held to JAX in
  tests/test_torch_training.py), with f32 gradients; ``build_decode_step(mesh=)``
  gives the unsharded step's greedy tokens;
- the expert-parallel MoE (``moe_impl="local"``) equals the global path at
  capacity 8.0 and at the published 1.25 with no data axis, and equals the
  reference's ``_moe_ffn_shard_map`` (y and aux) on a (2, 4) mesh, the
  reference run in a subprocess that forces 16 host devices (ROADMAP F12:
  with exactly 8, ``jax.make_mesh`` gives Explicit axes that its
  ``with_sharding_constraint`` refuses);
- a checkpoint saved on (2, 2) writes the unsharded files byte for byte and
  restores onto (4, 1) and onto one device.
"""
import os
import queue
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240        # seconds for one test's ranks
TRAIN_RTOL = 1e-5
ARCHS = ("qwen2-0.5b", "qwen2-moe-a2.7b", "mamba2-2.7b")
STEPS, DECODE = 3, 6


# ------------------------------------------------------------ rank harness
def _rank_main(rank, world, init_file, out, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        result = fn(rank, *args)
        out.put((rank, "ok", result))
    except BaseException:  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(tmp_path, world: int, fn, *args, timeout: float = TIMEOUT):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; rank 0's result."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = tmp_path / "rendezvous"
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(init), out, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, value = out.get(timeout=timeout)
            assert status == "ok", f"rank {rank}:\n{value}"
            results[rank] = value
    except queue.Empty:
        pytest.fail(f"the ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return results[0]


def _model(cfg, seed=0):
    from repro_torch.models.model import Model

    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


# ------------------------------------------------------------ sharded steps
def _steps_on_mesh(rank, arch, dims):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training import steps

    cfg = get_reduced(arch).with_(dtype="float32")
    ocfg = opt.OptimizerConfig(warmup_steps=1, grad_dtype="float32")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))}
               for _ in range(STEPS)]
    start = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32))

    def train(mesh):
        model = _model(cfg).requires_grad_(True)
        fn = steps.build_train_step(model, ocfg, mesh=mesh).fn
        state = opt.init_state(model.params, ocfg)
        out = []
        for b in batches:
            _, state, m = fn(model.params, state, b)
            out.append({k: float(v) for k, v in m.items()})
        return out

    def decode(mesh):
        model = _model(cfg)
        built = steps.build_decode_step(model, mesh=mesh)
        cache = model.init_cache(4, 16)
        if mesh is not None:
            cache = steps.place_cache(model, cache, mesh)
        token, out = start, []
        for pos in range(DECODE):
            token, cache = built.fn(model.params, token, cache, torch.tensor(pos))
            token = token.full_tensor() if hasattr(token, "full_tensor") else token
            out.append(token[:, 0].tolist())
        return out

    mesh = make_mesh(dims, ("data", "model"), "cpu")
    return {"want": train(None), "got": train(mesh),
            "want_tokens": decode(None), "got_tokens": decode(mesh)}


@pytest.mark.parametrize("dims", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_the_unsharded_port(tmp_path, arch, dims):
    r = _spawn(tmp_path, dims[0] * dims[1], _steps_on_mesh, arch, dims)
    for want, got in zip(r["want"], r["got"]):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=TRAIN_RTOL, abs=1e-7), (k, want, got)
    assert r["got_tokens"] == r["want_tokens"]


# ------------------------------------------------------- expert parallelism
def _moe_cfg(capacity):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import MoEConfig

    m = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=capacity)
    return get_reduced("qwen3-moe-235b-a22b").with_(dtype="float32", d_model=8, moe=m)


def _moe_params(p: dict):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


def _moe_no_data_axis(rank, capacities):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import partition

    mesh = make_mesh((4,), ("model",), "cpu")
    out = {}
    for cap in capacities:
        cfg = _moe_cfg(cap)
        p = moe.init_moe(torch.Generator().manual_seed(3), cfg, "cpu")
        x = torch.randn((4, 16, 8), generator=torch.Generator().manual_seed(4))
        yg, auxg = moe.moe_ffn(x, p, cfg)
        with partition.use_mesh(mesh, partition.rules_for(cfg)):
            assert moe._uses_shard_map(cfg.with_(moe_impl="local"))
            yl, auxl = moe.moe_ffn(x, p, cfg.with_(moe_impl="local"))
        out[cap] = (float((yl.full_tensor() - yg).abs().max()), float(auxl.full_tensor()),
                    float(auxg))
    return out


def test_expert_parallel_moe_equals_the_global_path(tmp_path):
    r = _spawn(tmp_path, 4, _moe_no_data_axis, (8.0, 1.25))
    for cap, (err, aux_local, aux_global) in r.items():
        assert err <= 1e-5, (cap, err)
        assert aux_local == pytest.approx(aux_global, rel=1e-6), cap


_JAX_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.configs.base import MoEConfig
from repro.models import moe as moe_mod
from repro.sharding import partition
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"))   # 16 devices: a Mesh with Auto axes
key = jax.random.PRNGKey(3)
m = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=float(sys.argv[2]))
cfg = get_reduced("qwen3-moe-235b-a22b").with_(dtype="float32", d_model=8, moe=m)
p, _ = moe_mod.init_moe(key, cfg)
x = jax.random.normal(key, (4, 16, 8), jnp.float32)
with partition.use_mesh(mesh):
    yl, auxl = jax.jit(lambda x, p: moe_mod.moe_ffn(x, p, cfg.with_(moe_impl="local")))(x, p)
np.savez(sys.argv[1], x=np.asarray(x), yl=np.asarray(yl), auxl=np.asarray(auxl),
         **{"p_" + k: np.asarray(v) for k, v in p.items()})
print("JAX_MOE_OK")
"""


def _moe_against_reference(rank, path, capacity):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import partition

    ref = np.load(path)
    cfg = _moe_cfg(capacity).with_(moe_impl="local")
    p = _moe_params({k[2:]: ref[k] for k in ref.files if k.startswith("p_")})
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    with partition.use_mesh(mesh, partition.rules_for(cfg)):
        y, aux = moe.moe_ffn(torch.from_numpy(ref["x"]), p, cfg)
    return (float((y.full_tensor() - torch.from_numpy(ref["yl"])).abs().max()),
            float(aux.full_tensor()), float(ref["auxl"]))


@pytest.mark.parametrize("capacity", [8.0, 1.25])
def test_expert_parallel_moe_equals_the_reference_shard_map(tmp_path, capacity):
    path = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_MOE, str(path), str(capacity)],
                         capture_output=True, text=True, env=env, timeout=TIMEOUT, cwd=ROOT)
    assert out.returncode == 0 and "JAX_MOE_OK" in out.stdout, out.stdout + out.stderr
    err, aux, aux_ref = _spawn(tmp_path, 8, _moe_against_reference, str(path), capacity)
    assert err <= 1e-5, err
    assert aux == pytest.approx(aux_ref, rel=1e-5)


# -------------------------------------------------------------- checkpoints
def _checkpoint_across_meshes(rank, directory):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import partition
    from repro_torch.training import optimizer as opt

    cfg = get_reduced("qwen2-0.5b")                        # bf16 weights
    full = _model(cfg).params
    want = {k: v.detach().clone() for k, v in _flatten(full)}
    model = _model(cfg).distribute(make_mesh((2, 2), ("data", "model"), "cpu"))
    sharded = Checkpointer(os.path.join(directory, "sharded"), async_save=False)
    sharded.save(7, {"params": model.params})
    if rank == 0:
        Checkpointer(os.path.join(directory, "plain"), async_save=False).save(
            7, {"params": full}, blocking=True)
    like = {"params": model.abstract_params()}
    other = make_mesh((4, 1), ("data", "model"), "cpu")
    shardings = {"params": partition.named_shardings(model.specs(), like["params"], other,
                                                     partition.rules_for(cfg))}
    step, back = sharded.restore(like, shardings=shardings)
    moved = {k: v for k, v in _flatten(back["params"])}
    placements = {k: [(type(p).__name__, getattr(p, "dim", None)) for p in v.placements]
                  for k, v in moved.items()}
    same = all(torch.equal(moved[k].full_tensor(), want[k]) for k in want)
    _, one = sharded.restore(like)
    same_one = all(torch.equal(v, want[k]) and not partition.is_dtensor(v)
                   for k, v in _flatten(one["params"]))
    return {"step": step, "same": same, "same_one": same_one, "placements": placements,
            "dtypes": sorted({str(v.dtype) for v in moved.values()})}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_checkpoint_saved_on_2x2_restores_onto_4x1_and_one_device(tmp_path):
    r = _spawn(tmp_path, 4, _checkpoint_across_meshes, str(tmp_path))
    assert r["step"] == 7 and r["same"] and r["same_one"]
    assert "torch.bfloat16" in r["dtypes"]
    # on (4, 1) the embedding's vocab takes no model split and its embed the data axis
    assert r["placements"]["/embed/tok"] == [("Shard", 1), ("Replicate", None)]
    sharded, plain = tmp_path / "sharded" / "step_00000007", tmp_path / "plain" / "step_00000007"
    leaves = sorted(p.name for p in plain.glob("leaf_*.npy"))
    assert leaves and leaves == sorted(p.name for p in sharded.glob("leaf_*.npy"))
    for name in leaves:
        assert (sharded / name).read_bytes() == (plain / name).read_bytes(), name
    from repro_torch.core import serializer
    manifests = [serializer.unpackb((d / "manifest.msgpack").read_bytes()) for d in (sharded, plain)]
    strip = [{k: v for k, v in m.items() if k != "time"} for m in manifests]
    assert strip[0] == strip[1]
