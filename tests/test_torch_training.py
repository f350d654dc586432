"""The port's training path against the JAX package's, on the CPU.

The same numpy-seeded inputs and the same JAX ``Model.init`` weights (carried
through ``repro_torch.params``) go through both packages: the cross-entropy,
``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` (JAX on
the CPU takes its kernels' plain ``ref`` path) for a reduced config of every
ported family, the optimizer, three train steps, microbatching, the data
pipeline, the trainer (with and without the fabric, with a resume) and the
training launcher. Tolerances, f32: the loss within 1e-5 relative; each
gradient leaf within 1e-4 of its largest |g|; train-step metrics within 1e-5
relative and weights within 3 lr absolute (AdamW's first steps move each
weight by about lr, so one gradient sign read differently moves it ~2 lr).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from conftest import make_batch  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import FunctionService  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import records_grad, refuse_grad  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import AUX_COEF, REMAT_SAVED_OPS, Model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.steps import build_train_step  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one reduced config per ported family (MLA is a dense config with ``mla``)
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b", "mla": "minicpm3-4b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b", "encdec": "whisper-small",
            "vlm": "internvl2-26b"}
B, S = 2, 24


def _assert_leaf_close(name, got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{name}: max |dg| {err:.3e} > {rel} x max |g| {scale:.3e}"


@functools.lru_cache(maxsize=None)
def _pair(arch: str, remat: bool = True):
    """(JAX model, JAX params, port model with the same weights), f32."""
    jmodel = JaxModel(jax_reduced(arch).with_(dtype="float32", remat=remat))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(arch).with_(dtype="float32", remat=remat), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


def _tensors(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_loss_and_grads(model, batch):
    model.requires_grad_(True)
    try:
        names, leaves = zip(*model.named_parameters())
        loss, metrics = model.loss(_tensors(batch))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        model.requires_grad_(False)
    return loss, metrics, dict(zip(names, grads))


def _jax_loss_and_grads(jmodel, jparams, batch):
    (loss, metrics), g = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    return loss, metrics, tparams.flatten(jax.tree.map(np.asarray, g))


# ---------------------------------------------------------- cross-entropy
@pytest.mark.parametrize("masked", [False, True, "all-zero"])
def test_cross_entropy_loss_matches_jax(masked):
    r = np.random.default_rng(0)
    logits = r.standard_normal((3, 7, 50)).astype(np.float32) * 3
    targets = r.integers(0, 50, (3, 7)).astype(np.int32)
    mask = None
    if masked:
        mask = (r.random((3, 7)) < 0.6).astype(np.float32)
        if masked == "all-zero":   # the max(mask.sum(), 1) denominator
            mask[:] = 0.0
    want = jax_layers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                         None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


# --------------------------------------------- the loss and every gradient
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_jax(family):
    jmodel, jparams, model = _pair(FAMILIES[family])
    batch = make_batch(jmodel.cfg, B, S)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    loss, metrics, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux", "loss"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, atol=1e-7)
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        assert np.abs(jgrads[name]).max() > 0, f"{name}: JAX gives it no gradient"
        _assert_leaf_close(name, g.numpy(), jgrads[name])
    if family == "vlm":   # the patch projection learns through the P - 1 slice
        assert float(grads["patch_proj"].abs().max()) > 0


def test_moe_aux_loss_reaches_the_router():
    """The fp32 aux loss leaves ``Model.forward`` uncopied, so the router
    learns from it as in JAX: its gradient from ``AUX_COEF * aux`` alone
    matches JAX's."""
    jmodel, jparams, model = _pair(FAMILIES["moe"])
    batch = make_batch(jmodel.cfg, B, S)
    jgrad = jax.grad(lambda p: AUX_COEF * jmodel.forward(p, batch)[1])(jparams)
    want = np.asarray(jgrad["layers"]["ffn"]["router"])
    model.requires_grad_(True)
    try:
        _, aux = model(_tensors(batch))
        assert aux.requires_grad and aux.dtype == torch.float32
        (got,) = torch.autograd.grad(AUX_COEF * aux, model.layers.ffn.router)
    finally:
        model.requires_grad_(False)
    assert np.abs(want).max() > 0
    _assert_leaf_close("layers.ffn.router", got.numpy(), want)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_masked_loss_and_gradients_match_jax(family):
    """A ``loss_mask``: shifted with the targets, except the VLM's (the
    reference uses it unshifted against all St tokens)."""
    jmodel, jparams, model = _pair(FAMILIES[family])
    batch = make_batch(jmodel.cfg, B, S)
    r = np.random.default_rng(1)
    batch["loss_mask"] = (r.random(batch["tokens"].shape) < 0.7).astype(np.float32)
    jloss, _, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    loss, _, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, g in grads.items():
        _assert_leaf_close(name, g.numpy(), jgrads[name])


def test_remat_changes_no_gradient():
    """``cfg.remat`` (each layer under torch.utils.checkpoint) against none."""
    _, _, model = _pair(FAMILIES["hybrid"])
    _, _, plain = _pair(FAMILIES["hybrid"], remat=False)
    batch = make_batch(model.cfg, B, S)
    loss, _, grads = _port_loss_and_grads(model, batch)
    loss0, _, grads0 = _port_loss_and_grads(plain, batch)
    assert loss.item() == loss0.item()
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=1e-6, atol=1e-7)


def test_other_remat_policies_wait_for_the_sharding_slice():
    """The reference's three remat policies are taken (the sharding slice no
    longer holds them back); a name outside them raises."""
    batch = _tensors(make_batch(get_reduced("qwen2-0.5b"), B, S))
    for policy in ("nothing", "dots", "dots_no_batch", "everything"):
        model = Model(get_reduced("qwen2-0.5b").with_(dtype="float32", remat_policy=policy),
                      device="cpu").init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.loss(batch)      # a forward autograd does not record needs no policy
        model.requires_grad_(True)
        if policy in REMAT_SAVED_OPS:
            assert torch.isfinite(model.loss(batch)[0])
        else:
            with pytest.raises(ValueError, match="remat_policy"):
                model.loss(batch)


@functools.lru_cache(maxsize=None)
def _policy_pair(arch: str, policy: str):
    """(JAX model, JAX params, port model with the same weights), f32, remat
    on under ``policy``."""
    jmodel = JaxModel(jax_reduced(arch).with_(dtype="float32", remat_policy=policy))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(arch).with_(dtype="float32", remat_policy=policy), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_policies_give_the_same_gradients_as_jax(family, policy):
    """Under "dots" and "dots_no_batch" every gradient leaf equals the one
    under "nothing" (the same arithmetic, only what is kept differs) and
    JAX's ``value_and_grad`` under the same policy."""
    jmodel, jparams, model = _policy_pair(FAMILIES[family], policy)
    _, _, plain = _pair(FAMILIES[family])
    batch = make_batch(jmodel.cfg, B, S)
    loss, _, grads = _port_loss_and_grads(model, batch)
    loss0, _, grads0 = _port_loss_and_grads(plain, batch)
    assert loss.item() == loss0.item()
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=0, atol=0)
    jloss, _, jgrads = _jax_loss_and_grads(jmodel, jparams, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, g in grads.items():
        _assert_leaf_close(name, g.numpy(), jgrads[name])


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.n["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(arch: str, remat: bool, policy: str = "nothing") -> dict:
    cfg = get_reduced(arch).with_(dtype="float32", remat=remat, remat_policy=policy)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).requires_grad_(True)
    loss, _ = model.loss(_tensors(make_batch(cfg, B, S)))
    with _CountProducts() as counted:
        torch.autograd.grad(loss, list(model.parameters()))
    return counted.n


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_dots_policies_recompute_what_they_should(arch):
    """The backward's products beyond those of a backward without remat are
    the recomputed ones: "nothing" recomputes products with and without a
    batch dimension, "dots" none, "dots_no_batch" only the batched ones
    (``bmm``: the plain attention's and scan's einsums), all of them."""
    base = _backward_products(arch, remat=False)
    extra = {p: {k: n - base[k] for k, n in _backward_products(arch, True, p).items()}
             for p in ("nothing", "dots", "dots_no_batch")}
    assert extra["nothing"]["mm"] > 0 and extra["nothing"]["bmm"] > 0
    assert extra["dots"] == {"mm": 0, "bmm": 0}
    assert extra["dots_no_batch"] == {"mm": 0, "bmm": extra["nothing"]["bmm"]}


def test_serving_keeps_the_weights_frozen_and_the_cached_views():
    """Weights are registered without grad; a trained model's cached per-layer
    views still see its weights (the optimizer writes them in place)."""
    _, _, model = _pair(FAMILIES["dense"])
    assert not any(p.requires_grad for p in model.parameters())
    views = model._layer_params
    assert model._per_layer() is views
    model.requires_grad_(True)
    try:
        fresh = model._per_layer()
        assert fresh is not views and fresh[0]["attn"]["wq"].grad_fn is not None
        torch.testing.assert_close(fresh[1]["attn"]["wq"], views[1]["attn"]["wq"])
    finally:
        model.requires_grad_(False)


# ----------------------------------------------- the kernels' autograd helpers
def test_records_grad_and_refuse_grad():
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not records_grad(a, None) and records_grad(a, b)
    refuse_grad("k", a, None)
    with pytest.raises(RuntimeError, match="no gradient"):
        refuse_grad("decode_attention", a, b)
    with torch.no_grad():
        assert not records_grad(b)
        refuse_grad("k", b)


# -------------------------------------------------------------- optimizer
def _tree(r, dtype):
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2)}, "e": ()}
    return jax.tree.map(lambda s: (r.standard_normal(s) * 0.5).astype(dtype), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))


def _torch_tree(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype or torch.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_schedule_and_global_norm_match_jax(dtype):
    r = np.random.default_rng(3)
    w0 = _tree(r, np.float32)
    ocfg = dataclasses.replace(jax_opt.OptimizerConfig(), lr=1e-2, warmup_steps=2,
                               total_steps=6, clip_norm=0.5)
    pcfg = opt.OptimizerConfig(**dataclasses.asdict(ocfg))
    tdt = getattr(torch, dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), w0)
    params = _torch_tree(w0, tdt)
    jstate, state = jax_opt.init_state(jparams, ocfg), opt.init_state(params, pcfg)
    for step in range(5):
        g = _tree(r, np.float32)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g)
        tg = _torch_tree(g, tdt)
        np.testing.assert_allclose(float(opt.global_norm(tg)), float(jax_opt.global_norm(jg)),
                                   rtol=1e-6)
        jparams, jstate = jax_opt.apply_updates(jg, jstate, ocfg,
                                                jax.tree.map(lambda p: p.dtype, jparams))
        params, state = opt.apply_updates(tg, state, pcfg, opt.tree_map(lambda p: p.dtype,
                                                                         params))
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        np.testing.assert_allclose(float(opt.schedule(pcfg, state["step"])),
                                   float(jax_opt.schedule(ocfg, jstate["step"])), rtol=1e-6)
        for name in ("master", "mu", "nu"):
            want = tparams.flatten(jax.tree.map(np.asarray, jstate[name]))
            got = tparams.flatten(state[name])
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-7, err_msg=k)
        want = tparams.flatten(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                            jparams))
        for k, p in tparams.flatten(params).items():
            assert p.dtype == tdt
            np.testing.assert_allclose(p.float().numpy(), want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10_000, 20_000])
def test_schedule_matches_jax(step):
    cfg = opt.OptimizerConfig()
    want = float(jax_opt.schedule(jax_opt.OptimizerConfig(), jnp.asarray(step)))
    np.testing.assert_allclose(float(opt.schedule(cfg, step)), want, rtol=1e-6)
    np.testing.assert_allclose(float(opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))),
                               want, rtol=1e-6)


def test_optimizer_config_defaults_match_jax():
    assert dataclasses.asdict(opt.OptimizerConfig()) == dataclasses.asdict(
        jax_opt.OptimizerConfig())


def test_stochastic_rounding_is_unbiased():
    """Mean of many draws within 1e-3 of the value; each draw one of the two
    bf16 values around it; a bf16-exact value never moves. (The reference's
    ``_sr_cast`` rounds to nearest: every draw of 1.003 gives 1.0.)"""
    gen = torch.Generator().manual_seed(0)
    for value in (1.003, -2.71828, 0.0123, 300.7):
        x = torch.full((200_000,), value)
        y = opt._sr_cast(x, torch.bfloat16, gen)
        assert y.dtype == torch.bfloat16
        spacing = 2.0 ** (np.floor(np.log2(abs(value))) - 7)   # bf16: 8 significant bits
        lo = np.floor(value / spacing) * spacing
        assert set(np.unique(y.float().numpy()).tolist()) == {lo, lo + spacing}
        assert abs(float(y.float().mean()) - value) <= 1e-3 * max(1.0, abs(value))
    exact = torch.tensor([1.5, -0.25, 0.0])
    assert torch.equal(opt._sr_cast(exact, torch.bfloat16, gen).float(), exact)
    want = jax_opt._sr_cast(jnp.full((1000,), 1.003), jnp.bfloat16, jax.random.PRNGKey(0))
    assert set(np.asarray(want.astype(jnp.float32)).tolist()) == {1.0}


def test_stochastic_rounding_on_the_update_path():
    gen = torch.Generator().manual_seed(1)
    cfg = opt.OptimizerConfig(stochastic_rounding=True, warmup_steps=0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init_state(params, cfg)
    new, state = opt.apply_updates({"w": torch.ones(4)}, state, cfg,
                                   {"w": torch.bfloat16}, sr_generator=gen)
    assert new["w"].dtype == torch.bfloat16 and state["master"]["w"].dtype == torch.float32


# ------------------------------------------------------------ train steps
def _train_cfgs(arch="qwen2-0.5b", **kw):
    ocfg = jax_opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10, **kw)
    return ocfg, opt.OptimizerConfig(**dataclasses.asdict(ocfg))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_three_train_steps_match_jax(family):
    arch = FAMILIES[family]
    jmodel = JaxModel(jax_reduced(arch).with_(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(arch).with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    model.requires_grad_(True)
    jcfg, pcfg = _train_cfgs()
    jstep = jax.jit(jax_build_train_step(jmodel, jcfg).fn)
    step = build_train_step(model, pcfg).fn
    jstate, params = jax_opt.init_state(jparams, jcfg), model.params
    state = opt.init_state(params, pcfg)
    for i in range(3):
        batch = jax_pipeline.synthetic_batch(jmodel.cfg, 2, 16, i)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, m = step(params, state, _tensors(batch))
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-8,
                                       err_msg=f"step {i + 1} {k}")
    want = tparams.flatten(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=3 * pcfg.lr,
                                   err_msg=name)


def test_microbatches_average_to_one_batch():
    """M = 2 microbatches give the one batch's loss and gradients (f32
    gradients, so the sum of halves is not rounded to bf16), and match JAX's
    M = 2 step."""
    cfg = get_reduced("qwen2-0.5b").with_(dtype="float32")
    batch = _tensors(pipeline.synthetic_batch(cfg, 4, 16, 0))
    jcfg, pcfg = _train_cfgs(grad_dtype="float32")
    out = {}
    for M in (1, 2):
        model = Model(cfg.with_(microbatches=M), device="cpu").init(
            torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        params = model.params
        _, _, m = build_train_step(model, pcfg).fn(params, opt.init_state(params, pcfg), batch)
        out[M] = (m, model.state_dict())
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(out[2][0][k]), float(out[1][0][k]), rtol=1e-5)
    for name, p in out[2][1].items():
        torch.testing.assert_close(p, out[1][1][name], rtol=0, atol=3 * pcfg.lr)

    jmodel = JaxModel(jax_reduced("qwen2-0.5b").with_(dtype="float32", microbatches=2))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg.with_(microbatches=2), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    model.requires_grad_(True)
    _, _, jm = jax_build_train_step(jmodel, jcfg).fn(
        jparams, jax_opt.init_state(jparams, jcfg), jax.tree.map(np.asarray, batch))
    params = model.params
    _, _, m = build_train_step(model, pcfg).fn(params, opt.init_state(params, pcfg), batch)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-8, err_msg=k)


def test_train_step_refuses_a_mesh():
    """The train step on a mesh is tests/test_torch_mesh.py's; it refuses a
    mesh other than the one the model's weights are distributed on."""
    model = Model(get_reduced("qwen2-0.5b"), device="cpu")
    model.mesh = object()
    with pytest.raises(ValueError, match="another mesh"):
        build_train_step(model, opt.OptimizerConfig(), mesh=object())


# ---------------------------------------------------------- data pipeline
@pytest.mark.parametrize("family", list(FAMILIES))
def test_pipeline_batches_equal_the_reference(family):
    arch = FAMILIES[family]
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    want = jax_pipeline.token_stream(jcfg, 2, 40, start_step=3)
    got = pipeline.Prefetcher(pipeline.token_stream(cfg, 2, 40, start_step=3), depth=2)
    try:
        for step in range(3, 7):
            w, g = next(want), next(got)
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(
                pipeline.synthetic_batch(cfg, 2, 40, step)["tokens"], w["tokens"])
    finally:
        got.close()


def test_prefetcher_transform_and_errors():
    pf = pipeline.Prefetcher(iter(range(5)), depth=2, transform=lambda x: x * 10)
    assert list(pf) == [0, 10, 20, 30, 40]

    def broken():
        yield 1
        raise RuntimeError("source failed")

    pf = pipeline.Prefetcher(broken(), depth=1)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(pf)


# ----------------------------------------------------------------- trainer
def _qwen2_model():
    return Model(get_reduced("qwen2-0.5b").with_(dtype="float32"), device="cpu")


# The synthetic tokens are uniform, so a batch's loss is noise around a slow
# fall toward log(vocab). At 8 x 64 tokens and lr 1e-2 the fall over 12
# steps (~0.4) is several times the batch noise (0.36-0.41 for weight seeds
# 0-4); at the reference test's 2 x 32 and 3e-3 it is not, in either package.
LEARNS = dict(lr=1e-2, batch=8, seq=64)


def test_trainer_loss_decreases_and_checkpoints(tmp_path):
    ocfg = opt.OptimizerConfig(lr=LEARNS["lr"], warmup_steps=2, total_steps=30)
    tcfg = TrainConfig(steps=12, batch=LEARNS["batch"], seq=LEARNS["seq"], ckpt_every=6,
                       ckpt_dir=str(tmp_path), log_every=0)
    trainer = Trainer(_qwen2_model(), ocfg, tcfg)
    history = trainer.run()
    assert len(history) == 12
    assert history[-1]["loss"] < history[0]["loss"]
    assert trainer.ckpt.latest_step() == 12
    assert trainer.ckpt.list_steps() == [6, 12]


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    model = _qwen2_model()
    tcfg = TrainConfig(steps=6, batch=2, seq=32, ckpt_every=3, ckpt_dir=str(tmp_path),
                       log_every=0)
    first = Trainer(model, ocfg, tcfg)
    first.run()
    at_six = {k: v.clone() for k, v in model.state_dict().items()}
    master = {k: v.clone() for k, v in tparams.flatten(first.opt_state["master"]).items()}
    # "controller restart": a new trainer resumes at step 6 and continues
    tcfg2 = TrainConfig(steps=10, batch=2, seq=32, ckpt_every=5, ckpt_dir=str(tmp_path),
                        log_every=0)
    t2 = Trainer(model, ocfg, tcfg2)
    assert t2.step == 6
    assert int(t2.opt_state["step"]) == 6
    for k, v in model.state_dict().items():
        assert torch.equal(v, at_six[k]), k
    for k, v in tparams.flatten(t2.opt_state["master"]).items():
        assert torch.equal(v, master[k]), k
    history = t2.run()
    assert len(history) == 4  # only steps 7..10 re-run
    assert [h["step"] for h in history] == [7, 8, 9, 10]
    assert t2.step == 10

    # the same ten steps in one run give the same losses
    straight = Trainer(_qwen2_model(), ocfg, TrainConfig(steps=10, batch=2, seq=32,
                                                         log_every=0)).run()
    np.testing.assert_allclose([h["loss"] for h in history],
                               [h["loss"] for h in straight[6:]], rtol=1e-5)


def test_trainer_through_faas_service():
    model = _qwen2_model()
    svc = FunctionService()
    svc.make_endpoint("train", n_executors=1, workers_per_executor=1)
    try:
        ocfg = opt.OptimizerConfig(lr=LEARNS["lr"], warmup_steps=2, total_steps=30)
        tcfg = TrainConfig(steps=12, batch=LEARNS["batch"], seq=LEARNS["seq"], ckpt_dir=None,
                           log_every=0)
        history = Trainer(model, ocfg, tcfg, service=svc).run()
        assert len(history) == 12
        assert all(np.isfinite(h["loss"]) for h in history)
        assert history[-1]["loss"] < history[0]["loss"]
        # the steps really went through the endpoint
        ep = list(svc.endpoints.values())[0]
        assert ep.completed >= 12
        inline = Trainer(_qwen2_model(), ocfg, tcfg).run()
        np.testing.assert_allclose([h["loss"] for h in history],
                                   [h["loss"] for h in inline], rtol=1e-6)
    finally:
        svc.shutdown()


def test_train_launcher_exits_zero_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--ckpt", str(tmp_path / "ckpt"), "--history-out", str(tmp_path / "h.json")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loss" in proc.stdout and (tmp_path / "h.json").exists()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000025", "step_00000050"]
