"""The MoE family on the card (``repro_torch.models.moe``).

Every test here is marked ``cuda`` and skips without a CUDA card of compute
capability 9.0 (the kernels have no CPU mode). The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py

A graphed engine captures its decode step after two eager warm-up steps under
``set_sync_debug_mode("error")``, so a host sync or a data-dependent shape in
the MoE path makes its construction raise. The graphed and the eager engine
run the same kernels in the same order, and the combine adds in a fixed
order, so their tokens and caches are held equal bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch: str, dtype: str, device) -> Model:
    cfg = get_reduced(arch).with_(dtype=dtype)
    return Model(cfg, device=device).init(torch.Generator(device).manual_seed(0))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _serve(engine, prompts, n_new):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    engine.run_until_drained(timeout=300)
    assert all(r.done.is_set() for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_moe_engine_equals_eager_engine(arch, dtype, cuda_device):
    """Six prompts over three slots at the published capacity (slots idle,
    decoding token 0, and are reused): the step captures, and the graphed
    and eager engines give equal tokens, equal step counts and equal caches."""
    model = _model(arch, dtype, cuda_device)
    L = model.cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 17, 3, 30, 9, 12)]
    n_new = [6, 3, 8, 4, 7, 5]
    graphed = ServeEngine(model, max_batch=3, max_len=64)
    eager = ServeEngine(model, max_batch=3, max_len=64, cuda_graph=False)
    assert graphed._graph.launches == {"flash_attention": 0, "decode_attention": L,
                                       "mla_decode_attention": 0,
                                       "flash_attention_backward": 0,
                                       "decode_attention_partials": 0,
                                       "mla_decode_attention_partials": 0,
                                       "fused_add_rmsnorm": L,
                                       "fused_add_rmsnorm_backward": 0, "ssd": 0,
                                       "ssd_backward": 0}
    assert _serve(graphed, prompts, n_new) == _serve(eager, prompts, n_new)
    assert graphed.steps == eager.steps
    for (name, g), (_, e) in zip(_leaves(graphed.cache), _leaves(eager.cache)):
        assert torch.equal(g, e), name


@pytest.mark.parametrize("T", [8, 300])
def test_moe_ffn_makes_no_host_sync(T, cuda_device):
    """A decode-sized and a prefill-sized call (with capacity drops) under
    the sync check."""
    model = _model("qwen2-moe-a2.7b", "bfloat16", cuda_device)
    x = torch.randn((1, T, model.cfg.d_model), device=cuda_device).to(torch.bfloat16)
    p = model._layer_params[0]["ffn"]
    moe.moe_ffn(x, p, model.cfg)                       # one-time set-up outside the check
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(x, p, model.cfg)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert y.shape == x.shape and torch.isfinite(y.float()).all() and torch.isfinite(aux)


@pytest.mark.parametrize("combine", ["scatter", "gather"])
def test_the_combine_is_bit_for_bit_repeatable(combine, cuda_device):
    """bf16, 512 tokens at the published capacity (some assignments drop):
    five calls give the same output and aux bit for bit."""
    model = _model("qwen2-moe-a2.7b", "bfloat16", cuda_device)
    cfg = model.cfg.with_(moe_combine=combine)
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=cuda_device).to(torch.bfloat16)
    p = model._layer_params[1]["ffn"]
    first, aux = moe.moe_ffn(x, p, cfg)
    for _ in range(4):
        again, again_aux = moe.moe_ffn(x, p, cfg)
        assert torch.equal(again, first) and torch.equal(again_aux, aux)


@pytest.mark.parametrize("combine", ["scatter", "gather"])
def test_moe_ffn_on_the_card_matches_the_cpu(combine, cuda_device):
    """f32 (TF32 off): the card's products sum in another order than the
    CPU's; held at the CPU parity tests' 2e-5."""
    model = _model("qwen3-moe-235b-a22b", "float32", cuda_device)
    cfg = model.cfg.with_(moe_combine=combine)
    gen = torch.Generator(cuda_device).manual_seed(2)
    x = torch.randn((2, 40, cfg.d_model), generator=gen, device=cuda_device)
    p = model._layer_params[0]["ffn"]
    y, aux = moe.moe_ffn(x, p, cfg)
    y_cpu, aux_cpu = moe.moe_ffn(x.cpu(), {k: v.cpu() for k, v in p.items()}, cfg)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=2e-5, atol=2e-5)


def test_full_width_init_peak_memory(cuda_device):
    """Full-width bf16 qwen2-moe-a2.7b (28.6 GB of weights) draws its weights
    one part at a time: the peak stays under 60 GB and within one part's draw
    of the weights (the embedding's f32 draw and its bf16 cast, 1.9 GB, or
    one layer's leaves and one f32 leaf)."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = Model(get_config("qwen2-moe-a2.7b"), device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    peak = torch.cuda.max_memory_allocated() - base
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"weights {weights / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB")
    assert peak < 60e9
    assert peak - weights < 2.5e9
    assert torch.isfinite(model.params["layers"]["ffn"]["wi"][-1, -1].float()).all()
    del model
    torch.cuda.empty_cache()
