"""The serve engine's graphed decode step on the card.

Every test here is marked ``cuda`` and skips without a CUDA card of compute
capability 9.0 (the kernels have no CPU mode). The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py

A graphed engine (``ServeEngine``'s default on the card) and an eager one
(``cuda_graph=False``) run the same kernels in the same order, so their tokens
and caches are held equal bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

ARCHS = ["qwen2-0.5b", "mamba2-2.7b", "zamba2-2.7b", "minicpm3-4b", "whisper-small",
         "internvl2-26b"]


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
def test_graphed_engine_equals_eager_engine(arch, dtype, cuda_device):
    """Six prompts of mixed lengths and budgets over three slots (slots idle
    and are reused): equal tokens, equal step counts, and every cache leaf
    equal bit for bit after the run."""
    model = _model(arch, dtype, cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 17, 3, 30, 9, 12)]
    n_new = [6, 3, 8, 4, 7, 5]
    graphed = ServeEngine(model, max_batch=3, max_len=64)
    eager = ServeEngine(model, max_batch=3, max_len=64, cuda_graph=False)
    assert graphed._graph is not None and eager._graph is None
    assert _serve(graphed, prompts, n_new) == _serve(eager, prompts, n_new)
    assert graphed.steps == eager.steps
    for (name, g), (_, e) in zip(_leaves(graphed.cache), _leaves(eager.cache)):
        assert torch.equal(g, e), name


class _KeepLogits(ServeEngine):
    """An engine whose step keeps its logits (in a graphed engine, the
    captured step's static output, which each replay rewrites)."""

    def _decode(self) -> None:
        logits, _ = self.model.decode_step(self._tokens, self.cache, self._positions)
        self.logits = logits
        torch.argmax(logits, dim=-1, out=self._sampled)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_encdec_step_reads_each_new_slots_cross_cache(dtype, cuda_device):
    """whisper reduced: two admissions, each with its own frames, into two
    slots, a step after each; the graphed step's logits and every cache leaf
    equal the eager step's bit for bit. The captured flash call (its TMA
    descriptors encoded once, at capture) reads each slot's cross keys and
    values from the fixed cache, where admission wrote them."""
    model = _model("whisper-small", dtype, cuda_device)
    cfg = model.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (6, 11)]
    frames = [rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype(np.float32)
              for _ in prompts]
    engines = [_KeepLogits(model, max_batch=3, max_len=32),
               _KeepLogits(model, max_batch=3, max_len=32, cuda_graph=False)]
    assert engines[0]._graph is not None and engines[1]._graph is None
    logits = [[], []]
    for p, f in zip(prompts, frames):
        for e, out in zip(engines, logits):
            e.submit(p, max_new_tokens=8, frames=f)
            e._admit()
            e._step()
            out.append(e.logits.clone())
    assert engines[0].slot_req[1] is not None                    # the second slot is in use
    for g, e in zip(*logits):
        assert torch.equal(g, e)
    for (name, g), (_, e) in zip(_leaves(engines[0].cache), _leaves(engines[1].cache)):
        assert torch.equal(g, e), name
    cross = engines[0].cache["cross_k"]
    assert cross[:, 1].abs().sum() > 0 and not torch.equal(cross[:, 0], cross[:, 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_vlm_step_equals_eager_after_admissions_with_patches(dtype, cuda_device):
    """internvl2 reduced: two admissions, each with its own patches, into two
    slots, a step after each; the graphed step's logits and every cache leaf
    equal the eager step's bit for bit, each slot decoding at n_patches + its
    prompt's length."""
    model = _model("internvl2-26b", dtype, cuda_device)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (6, 11)]
    patches = [rng.standard_normal((cfg.n_patches, cfg.d_model)).astype(np.float32)
               for _ in prompts]
    engines = [_KeepLogits(model, max_batch=3, max_len=48),
               _KeepLogits(model, max_batch=3, max_len=48, cuda_graph=False)]
    assert engines[0]._graph is not None and engines[1]._graph is None
    logits = [[], []]
    for p, x in zip(prompts, patches):
        for e, out in zip(engines, logits):
            e.submit(p, max_new_tokens=8, patches=x)
            e._admit()
            e._step()
            out.append(e.logits.clone())
    for e in engines:
        assert list(e.slot_pos[:2]) == [cfg.n_patches + 6 + 2, cfg.n_patches + 11 + 1]
    for g, e in zip(*logits):
        assert torch.equal(g, e)
    for (name, g), (_, e) in zip(_leaves(engines[0].cache), _leaves(engines[1].cache)):
        assert torch.equal(g, e), name


def test_a_host_sync_in_the_step_makes_construction_raise(cuda_device, monkeypatch):
    """A step that waits on the device (``.item()`` in every RMSNorm) fails
    the warm-up under the sync check, and the engine raises rather than step
    eagerly; the sync debug mode is restored."""
    model = _model("qwen2-0.5b", "float32", cuda_device)
    rmsnorm = layers.rmsnorm

    def syncing_rmsnorm(x, p, eps=1e-5):
        x.sum().item()
        return rmsnorm(x, p, eps)

    monkeypatch.setattr(layers, "rmsnorm", syncing_rmsnorm)
    mode = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchroniz"):
        ServeEngine(model, max_batch=2, max_len=32)
    assert torch.cuda.get_sync_debug_mode() == mode


def test_a_replay_adds_the_captured_calls_to_launches(cuda_device):
    """zamba2 reduced, bf16: the capture counts one decode attention and one
    add + norm per group, and a served request moves each counter by exactly
    its prefill's calls plus the captured calls times the steps."""
    model = _model("zamba2-2.7b", "bfloat16", cuda_device)
    cfg = model.cfg
    G = cfg.n_layers // cfg.shared_attn_every
    engine = ServeEngine(model, max_batch=2, max_len=32)
    assert engine._graph.launches == {"flash_attention": 0, "decode_attention": G,
                                      "mla_decode_attention": 0,
                                      "flash_attention_backward": 0,
                                      "decode_attention_partials": 0,
                                      "mla_decode_attention_partials": 0,
                                      "fused_add_rmsnorm": G, "ssd": 0}
    before = tengine.launch_counts()
    engine.submit(np.arange(7), max_new_tokens=4)
    engine.run_until_drained(timeout=120)
    after = tengine.launch_counts()
    steps = engine.steps
    assert steps == 3
    assert {k: after[k] - before[k] for k in after} == {
        "flash_attention": G, "decode_attention": steps * G, "mla_decode_attention": 0,
        "flash_attention_backward": 0, "decode_attention_partials": 0,
        "mla_decode_attention_partials": 0,
        "fused_add_rmsnorm": (1 + steps) * G, "ssd": cfg.n_layers}


def test_changing_kernel_impl_after_capture_raises(cuda_device):
    model = _model("qwen2-0.5b", "float32", cuda_device)
    engine = ServeEngine(model, max_batch=2, max_len=32)
    engine.submit(np.arange(5), max_new_tokens=4)
    model.kernel_impl = "ref"
    with pytest.raises(RuntimeError, match="kernel_impl"):
        engine.run_until_drained(timeout=60)
