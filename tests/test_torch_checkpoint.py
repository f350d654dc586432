"""The port's checkpointer against the JAX package's, on the CPU.

The same training state (a reduced model's weights and optimizer state, from
the JAX init) saved by both packages gives byte-identical ``.npy`` files and
equal manifests (apart from ``time``), in f32 and bf16; each package restores
the other's checkpoints. The port restores a bf16 leaf as bf16 (F8): the
reference gives it back as raw ``|V2`` bytes.
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import serializer as jax_serializer  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import serializer  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _jax_state(dtype: str):
    """A reduced MoE's weights and optimizer state one step in (every kind of
    leaf: bf16 or f32 weights, f32 master and moments, the int32 step)."""
    model = JaxModel(jax_reduced("qwen2-moe-a2.7b").with_(dtype=dtype))
    params = model.init(jax.random.PRNGKey(0))
    state = jax_opt.init_state(params, jax_opt.OptimizerConfig())
    grads = jax.tree.map(lambda p: (p * 0.5).astype(p.dtype), params)
    params, state = jax_opt.apply_updates(grads, state, jax_opt.OptimizerConfig(),
                                          jax.tree.map(lambda p: p.dtype, params))
    return {"params": params, "opt": state}


def _to_port(tree):
    return jax.tree.map(lambda a: tparams.to_tensor(np.asarray(a), "cpu"), tree)


def _files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".npy"))


def _manifest(path, codec):
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        m = codec.unpackb(f.read())
    m.pop("time")
    return m


@pytest.mark.parametrize("dtype", DTYPES)
def test_both_packages_write_the_same_files(tmp_path, dtype):
    state = _jax_state(dtype)
    jpath = JaxCheckpointer(str(tmp_path / "jax"), async_save=False).save(7, state)
    path = Checkpointer(str(tmp_path / "port"), async_save=False).save(7, _to_port(state))
    assert os.path.basename(path) == os.path.basename(jpath) == "step_00000007"
    assert _files(path) == _files(jpath) and len(_files(path)) > 10
    for name in _files(path):
        with open(os.path.join(path, name), "rb") as a, open(os.path.join(jpath, name), "rb") as b:
            assert a.read() == b.read(), name
    m, jm = _manifest(path, serializer), _manifest(jpath, jax_serializer)
    assert m == jm
    keys = [leaf["key"] for leaf in m["leaves"]]
    assert keys[0].startswith("opt/master/") and "opt/step" in keys
    assert "params/layers/attn/wq" in keys
    assert {leaf["dtype"] for leaf in m["leaves"]} == (
        {"float32", "int32"} | ({"bfloat16"} if dtype == "bfloat16" else set()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    """Leaves come back by key, in their saved dtype: bf16 as bf16 (F8)."""
    state = _jax_state(dtype)
    JaxCheckpointer(str(tmp_path), async_save=False).save(3, state)
    like = _to_port(state)
    step, got = Checkpointer(str(tmp_path)).restore(like)
    assert step == 3
    want = tparams.flatten(like)
    flat = tparams.flatten(got)
    assert flat.keys() == want.keys()
    for k, w in want.items():
        assert flat[k].dtype == w.dtype, k
        assert torch.equal(flat[k], w), k
    assert tparams.flatten(got["params"])["embed.tok"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_port_checkpoint_restores_in_jax(tmp_path, dtype):
    """f32 and int32 leaves come back equal; the reference gives a bf16 leaf
    back as ``|V2`` (F8, repaired only in the port), with the right bytes."""
    state = _jax_state(dtype)
    Checkpointer(str(tmp_path), async_save=False).save(4, _to_port(state))
    step, got = JaxCheckpointer(str(tmp_path)).restore(state)
    assert step == 4
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(state)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype.str == "|V2", path
            assert g.tobytes() == w.tobytes(), path
        else:
            assert g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w)


def test_the_port_restores_bf16_as_bf16(tmp_path):
    t = torch.tensor([[1.5, -2.25, 3.0e-3], [65504.0, -0.0, 1e-30]]).to(torch.bfloat16)
    tree = {"w": t, "b": {"step": torch.tensor(9, dtype=torch.int32)}}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, tree)
    _, got = ck.restore(tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    assert got["b"]["step"].dtype == torch.int32 and int(got["b"]["step"]) == 9
    with open(os.path.join(tmp_path, "step_00000001", "leaf_00001.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)


def test_a_mismatched_key_or_shape_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="only in the template"):
        ck.restore({"a": torch.ones(2), "b": torch.ones(3), "c": torch.ones(1)})
    with pytest.raises(ValueError, match="only in the checkpoint"):
        ck.restore({"a": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"a": torch.ones(2), "b": torch.ones(4)})
    # the same keys in another nesting order restore by key, not by position
    _, got = ck.restore({"b": torch.zeros(3), "a": torch.zeros(2)})
    assert got["a"].shape == (2,) and got["b"].shape == (3,)


def test_async_save_then_restore_keep_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.ones(1)})
    for step in (5, 10, 15):
        ck.save(step, {"w": torch.full((8, 8), float(step))})
    ck.wait()
    assert ck.list_steps() == [10, 15]  # keep=2 garbage-collected step 5
    step, got = ck.restore({"w": torch.zeros(8, 8)})
    assert step == 15 and float(got["w"][0, 0]) == 15.0
    step, got = ck.restore({"w": torch.zeros(8, 8)}, step=10)
    assert step == 10 and float(got["w"][0, 0]) == 10.0
