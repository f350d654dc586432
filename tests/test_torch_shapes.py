"""The assigned shapes and the step builders of the port against the JAX package's.

``SHAPES``, ``cell_applicable`` and ``all_cells`` equal ``repro.configs``';
``batch_avals`` gives the reference's shapes and dtypes for every arch and
shape (meta tensors where JAX has ``ShapeDtypeStruct``s). ``build_prefill_step``
and ``build_decode_step`` (no mesh) run a reduced config of each family on
JAX ``Model.init`` weights carried into the port, on the same numpy batch, and
are held to ``jax.jit`` of the reference's ``.fn``: the next tokens equal, the
logits and every cache leaf within tests/test_decode_equivalence.py's
tolerances (2e-4 prefill, 3e-4 decode, f32). The MoE runs at capacity factor
8.0, as tests/test_torch_model.py does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_batch  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.training import steps as jax_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import steps  # noqa: E402

FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b", "mla": "minicpm3-4b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b", "encdec": "whisper-small",
            "vlm": "internvl2-26b"}
B, PREFILL, CACHE = 2, 16, 24


def test_shapes_and_cells_equal_the_reference():
    assert configs.SHAPES == {k: configs.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jax_configs.SHAPES.items()}
    assert configs.all_cells() == jax_configs.all_cells()
    assert len(configs.all_cells()) == 40
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            assert configs.cell_applicable(configs.get_config(arch), shape) == \
                jax_configs.cell_applicable(jax_configs.get_config(arch),
                                            jax_configs.SHAPES[name])


@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_avals_and_specs_equal_the_reference(arch, shape):
    ours = steps.batch_avals(configs.get_config(arch), configs.SHAPES[shape])
    theirs = jax_steps.batch_avals(jax_configs.get_config(arch), jax_configs.SHAPES[shape])
    assert set(ours) == set(theirs)
    for k, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(theirs[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(theirs[k].dtype), k
    assert steps.batch_logical_specs(configs.get_config(arch), configs.SHAPES[shape]) == \
        jax_steps.batch_logical_specs(jax_configs.get_config(arch), jax_configs.SHAPES[shape])


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    jmodel = JaxModel(_no_drop(jax_configs.get_reduced(arch).with_(dtype="float32")))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(_no_drop(configs.get_reduced(arch).with_(dtype="float32")), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_close(ours: dict, theirs: dict, tol: float) -> None:
    ours, theirs = dict(_leaves(ours)), dict(_leaves(theirs))
    assert set(ours) == set(theirs)
    for name, t in ours.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(theirs[name]), rtol=tol, atol=tol,
                                   err_msg=name)


def _blit(cache: dict, seq_cache: dict) -> None:
    """A prefill cache into the leading entries of a zero cache (numpy)."""
    for name, dst in cache.items():
        src = seq_cache[name]
        if isinstance(dst, dict):
            _blit(dst, src)
        else:
            dst[tuple(slice(0, n) for n in src.shape)] = np.asarray(src)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_steps_match_jax(family):
    jmodel, jparams, model = _pair(FAMILIES[family])
    cfg = model.cfg
    batch = make_batch(jmodel.cfg, B, PREFILL)
    jnext, jlogits, jcache = jax.jit(jax_steps.build_prefill_step(jmodel).fn)(
        jparams, jax.tree.map(jnp.asarray, batch))
    built = steps.build_prefill_step(model)
    assert (built.in_shardings, built.out_shardings, built.donate_argnums,
            built.abstract_args) == (None, None, (), ())
    nxt, logits, cache = built.fn(model.params, _torch(batch))
    assert nxt.dtype == torch.int32 and nxt.shape == (B,)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    _assert_trees_close(cache, jcache, 2e-4)

    # one decode step at position PREFILL from the prefill's cache in a longer one
    zero, _ = jmodel.init_cache(B, CACHE)
    full = jax.tree.map(np.array, zero)
    _blit(full, jax.tree.map(np.asarray, jcache))
    token = np.array(jnext)[:, None]
    jtok, jnew = jax.jit(jax_steps.build_decode_step(jmodel).fn)(
        jparams, jnp.asarray(token), jax.tree.map(jnp.asarray, full), jnp.int32(PREFILL))
    built = steps.build_decode_step(model)
    assert built.donate_argnums == (2,) and built.abstract_args == ()
    ours = _torch(full)
    tok, new = built.fn(model.params, torch.from_numpy(token), ours, torch.tensor(PREFILL))
    assert new is ours                      # written in place
    assert tok.dtype == torch.int32 and tok.shape == (B, 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _assert_trees_close(new, jnew, 3e-4)
    assert cfg.family == jmodel.cfg.family


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_mesh_raises_naming_the_sharding_slice(kind):
    """Since the mesh half of A5 a builder distributes the model onto its mesh
    (tests/test_torch_mesh.py); what raises is a mesh other than the one the
    model's weights are already on."""
    model = Model(configs.get_reduced("qwen2-0.5b"), device="cpu")
    build = {"train": functools.partial(steps.build_train_step, ocfg=opt.OptimizerConfig()),
             "prefill": steps.build_prefill_step, "decode": steps.build_decode_step}[kind]
    model.mesh = object()
    with pytest.raises(ValueError, match="another mesh"):
        build(model, mesh=object())


def test_abstract_args_are_the_cells_meta_stand_ins():
    """With a shape, ``abstract_args`` holds meta stand-ins of every argument:
    the weights, the optimizer state and the batch; the decode cache at the
    cell's length and a scalar position. A step refuses weights other than the
    model's."""
    cfg = configs.get_reduced("zamba2-2.7b")
    model = Model(cfg, device="cpu")
    shape = configs.ShapeSpec("t", "train", 32, 2)
    params, state, batch = steps.build_train_step(model, opt.OptimizerConfig(),
                                                  shape=shape).abstract_args
    assert all(p.device.type == "meta" for p in opt.tree_leaves(params))
    assert [tuple(p.shape) for p in opt.tree_leaves(params)] == \
        [tuple(p.shape) for p in opt.tree_leaves(model.params)]
    assert state["master"]["embed"]["tok"].dtype == torch.float32
    assert tuple(batch["tokens"].shape) == (2, 32)
    shape = configs.ShapeSpec("d", "decode", 64, 3)
    _, token, cache, pos = steps.build_decode_step(model, shape=shape).abstract_args
    assert tuple(token.shape) == (3, 1) and pos.shape == () and pos.device.type == "meta"
    assert {k: tuple(v.shape) for k, v in _leaves(cache)} == \
        {k: tuple(v.shape) for k, v in _leaves(model.init_cache(3, 64))}
    with pytest.raises(ValueError, match="model.params"):
        steps.build_prefill_step(model).fn(Model(cfg, device="cpu").params,
                                           {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
