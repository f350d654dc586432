"""The attention backward's plain version and autograd Function against JAX.

The port's backward kernel (``csrc/flash_attention_backward.cu``) runs only on
the card; its plain version, ``ref.mha_backward_reference`` (the explicit
FlashAttention-2 formulas), is held here against ``jax.grad`` of the JAX
package's ``mha_reference`` on the same numpy inputs, in f32, within 1e-5
relative L2 for each of dq, dk and dv (the two sum in other orders). Rows
with no valid key are left out of that comparison: JAX averages v there
(F6), the port gives zeros; they are held against autograd of the port's own
``mha_reference``. ``ref.mha_forward_with_lse_reference``'s log-sum-exp is
held against ``jax.nn.logsumexp`` of the JAX reference's masked scores (1e-6
relative). ``kernel.FlashAttentionGrad`` runs with the plain pair in the
kernels' place: ``torch.autograd.gradcheck`` in float64, ``None`` for inputs
that need no gradient, and under ``torch.utils.checkpoint`` (a forward, a
recompute and one backward) equal to autograd of ``mha_reference`` within
1e-5. The card's tests hold the kernels to these plain versions
(tests/test_torch_kernels_cuda.py). The launcher's host plan
(``csrc/flash_backward_plan.cuh``, plain C++) is compiled with the host
compiler and held here: each key tile's query tiles against the masks, the
scratch's size, and the bf16 dK/dV pass's sub-group rule.
"""
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

REL_L2 = 1e-5   # f32: each gradient's relative L2 distance, port against JAX
# (id, (B, Sq, Skv, H, KV, dqk, dv), kwargs)
CASES = [
    ("causal-G1", (2, 16, 16, 3, 3, 16, 16), {"causal": True}),
    ("noncausal-G2-Sq-ne-Skv", (2, 12, 20, 4, 2, 16, 16), {"causal": False}),
    ("causal-G7", (1, 24, 24, 7, 1, 8, 8), {"causal": True}),
    ("q_offset", (2, 8, 24, 4, 2, 16, 16), {"causal": True, "q_offset": 16}),
    ("kv_len-per-row-with-0", (3, 16, 16, 4, 2, 16, 16), {"causal": True, "kv_len": [16, 0, 5]}),
    ("dqk-24-dv-16-scale", (2, 16, 16, 4, 4, 24, 16), {"causal": True, "scale": 0.3}),
    ("noncausal-kv_len", (2, 10, 18, 6, 2, 8, 16), {"causal": False, "kv_len": 7}),
    ("negative-q_offset", (1, 12, 12, 2, 1, 8, 8), {"causal": True, "q_offset": -4}),
    ("G7-q_offset-kv_len", (2, 6, 30, 7, 1, 16, 8),
     {"causal": True, "q_offset": 20, "kv_len": [30, 23]}),
]
IDS = [c[0] for c in CASES]


def _arrays(case, seed):
    """q, k, v and the output's gradient as f32 numpy arrays."""
    _, (B, Sq, Skv, H, KV, dqk, dv), _ = case
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dqk), (B, Skv, KV, dqk), (B, Skv, KV, dv), (B, Sq, H, dv))]


def _kw(case, lib):
    """The case's kwargs with a per-row kv_len as an array of ``lib``."""
    kw = dict(case[2])
    if isinstance(kw.get("kv_len"), list):
        kw["kv_len"] = (torch.tensor if lib == "torch" else jnp.asarray)(kw["kv_len"])
    return kw


def _valid_rows(case) -> np.ndarray:
    """(B, Sq): whether query row i of batch row b sees at least one key."""
    _, (B, Sq, Skv, *_), kw = case
    kv_len = np.broadcast_to(np.asarray(kw.get("kv_len", Skv)), (B,))
    last = np.arange(Sq) + kw.get("q_offset", 0) if kw.get("causal", True) else \
        np.full(Sq, Skv - 1)
    return (np.minimum(last[None, :], kv_len[:, None] - 1) >= 0)


def _port_backward(q, k, v, do, kw):
    o, lse = tref.mha_forward_with_lse_reference(q, k, v, **kw)
    return tref.mha_backward_reference(q, k, v, o, do, lse, **kw)


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)
                 for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mha_backward_reference_matches_jax_grad(case):
    """dq, dk, dv of the port's plain backward against jax.grad of the JAX
    reference, each within REL_L2; rows with no valid key carry a zero
    output gradient here (JAX averages v there)."""
    q, k, v, do = _arrays(case, 0)
    do = do * _valid_rows(case)[:, :, None, None]

    def loss(q, k, v):
        return jnp.sum(jref.mha_reference(q, k, v, **_kw(case, "jax")) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got = _port_backward(*(torch.from_numpy(x) for x in (q, k, v, do)), _kw(case, "torch"))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        rel = _rel_l2(g.numpy(), w)
        assert rel <= REL_L2, f"d{name}: relative L2 {rel:.3e} against jax.grad"


@pytest.mark.parametrize("case", [c for c in CASES if not _valid_rows(c).all()],
                         ids=[c[0] for c in CASES if not _valid_rows(c).all()])
def test_rows_with_no_valid_key_match_autograd_of_the_port(case):
    """Where some row sees no key, the plain backward with every row's
    output gradient equals autograd of the port's ``mha_reference`` within
    REL_L2, and such a row's dq is exactly zero."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(case, 1))
    kw = _kw(case, "torch")
    got = _port_backward(q, k, v, do, kw)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.mha_reference(*xs, **kw), xs, do)
    for name, g, w in zip("qkv", got, want):
        assert _rel_l2(g, w) <= REL_L2, f"d{name}"
    empty = torch.from_numpy(~_valid_rows(case))
    assert torch.equal(got[0][empty], torch.zeros_like(got[0][empty]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_lse_matches_jax_logsumexp(case):
    """``mha_forward_with_lse_reference``: o is ``mha_reference``'s bit for
    bit; lse (B, H, Sq) is jax.nn.logsumexp of the JAX reference's scaled,
    masked scores on every row with a key, and -inf on the rest."""
    q, k, v, _ = _arrays(case, 2)
    kw = _kw(case, "torch")
    o, lse = tref.mha_forward_with_lse_reference(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert torch.equal(o, tref.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)), **kw))
    _, (B, Sq, Skv, H, KV, dqk, _), jkw = case
    G = H // KV
    scale = jkw.get("scale", dqk ** -0.5)
    s = jnp.einsum("bskgd,btkd->bkgst", jnp.asarray(q).reshape(B, Sq, KV, G, dqk),
                   jnp.asarray(k)) * scale
    # the JAX reference's mask (src/repro/kernels/flash_attention/ref.py)
    kv_pos = jnp.arange(Skv)
    mask = jnp.ones((Sq, Skv), dtype=bool)
    if jkw.get("causal", True):
        mask = mask & (kv_pos[None, :] <= jnp.arange(Sq)[:, None] + jkw.get("q_offset", 0))
    if "kv_len" in jkw:
        kl = jnp.asarray(jkw["kv_len"])
        mask = mask & (kv_pos[None, :] < kl) if kl.ndim == 0 else \
            mask[None] & (kv_pos[None, None, :] < kl[:, None, None])
    mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, jref.NEG_INF), axis=-1))
    want = want.reshape(B, H, Sq)
    valid = np.broadcast_to(_valid_rows(case)[:, None, :], (B, H, Sq))
    got = lse.numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-6, atol=1e-6)
    assert np.all(np.isneginf(got[~valid]))


def _function(kw, calls=None):
    """``FlashAttentionGrad`` with the plain pair in the kernels' place;
    ``calls`` counts each callable's calls."""
    fwd = functools.partial(tref.mha_forward_with_lse_reference, **kw)
    bwd = functools.partial(tref.mha_backward_reference, **kw)
    if calls is not None:
        fwd0, bwd0 = fwd, bwd

        def fwd(*a):
            calls["forward"] += 1
            return fwd0(*a)

        def bwd(*a):
            calls["backward"] += 1
            return bwd0(*a)

    return lambda q, k, v: tkernel.FlashAttentionGrad.apply(fwd, bwd, q, k, v)


@pytest.mark.parametrize("kw", [{"causal": True, "kv_len": [5, 0]},
                                {"causal": True, "q_offset": 3, "kv_len": [7, 4]},
                                {"causal": False, "kv_len": [2, 7]}],
                         ids=["causal-kv_len-0", "q_offset", "noncausal"])
def test_function_gradcheck_float64(kw):
    """The Function's analytic gradient (the plain backward) against finite
    differences of its forward, float64, GQA 4/2 with dqk 8 and dv 4."""
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal(s)).requires_grad_()
               for s in ((2, 7, 4, 8), (2, 7, 2, 8), (2, 7, 2, 4)))
    kw = {n: torch.tensor(x) if isinstance(x, list) else x for n, x in kw.items()}
    assert torch.autograd.gradcheck(_function(kw), (q, k, v))


def test_function_returns_none_for_inputs_that_need_no_gradient():
    """With only q requiring grad, the Function's backward returns a
    gradient for q alone (and none for its two callables)."""
    r = np.random.default_rng(4)
    q, k, v, go = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((1, 9, 4, 8), (1, 9, 2, 8), (1, 9, 2, 8), (1, 9, 4, 8)))
    q.requires_grad_()
    out = _function({"causal": True})(q, k, v)
    grads = out.grad_fn.apply(go)
    assert len(grads) == 5 and grads[0] is None and grads[1] is None
    assert grads[2] is not None and grads[3] is None and grads[4] is None
    want = torch.autograd.grad(tref.mha_reference(q, k, v, causal=True), q, go)[0]
    assert _rel_l2(grads[2], want) <= REL_L2


@pytest.mark.parametrize("causal", [True, False])
def test_function_under_checkpoint_matches_autograd_of_mha_reference(causal):
    """Under ``torch.utils.checkpoint`` (non-reentrant, as the models' remat)
    the Function runs its forward twice (forward and recompute) and its
    backward once; its gradients equal autograd of ``mha_reference`` within
    REL_L2."""
    from torch.utils.checkpoint import checkpoint

    r = np.random.default_rng(5)
    q, k, v, go = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((2, 33, 6, 16), (2, 33, 2, 16), (2, 33, 2, 16), (2, 33, 6, 16)))
    xs = [t.requires_grad_() for t in (q, k, v)]
    kw = {"causal": causal, "kv_len": torch.tensor([33, 20])}
    calls = {"forward": 0, "backward": 0}
    fn = _function(kw, calls)
    out = checkpoint(lambda q, k, v: fn(q, k, v) * 2.0, *xs, use_reentrant=False)
    got = torch.autograd.grad(out, xs, go)
    assert calls == {"forward": 2, "backward": 1}
    want = torch.autograd.grad(tref.mha_reference(*xs, **kw) * 2.0, xs, go)
    for name, g, w in zip("qkv", got, want):
        assert _rel_l2(g, w) <= REL_L2, f"d{name}"


def test_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors ``flash_attention_backward`` is the plain backward and
    ``flash_attention`` under autograd is ``mha_reference`` differentiated
    by autograd, bit for bit; no kernel launch is counted."""
    r = np.random.default_rng(6)
    q, k, v, go = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((2, 9, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8), (2, 9, 4, 8)))
    before = dict(tkernel.LAUNCHES)
    o, lse = tref.mha_forward_with_lse_reference(q, k, v)
    got = tkernel.flash_attention_backward(q, k, v, o, go, lse)
    for g, w in zip(got, tref.mha_backward_reference(q, k, v, o, go, lse)):
        assert torch.equal(g, w)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tkernel.flash_attention(*xs), xs, go)
    want = torch.autograd.grad(tref.mha_reference(*xs), xs, go)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tkernel.LAUNCHES == before


# --------------------------------------------------------------------- host plan
# The card's launcher plans its scratch and the bf16 dK/dV pass's sub-groups
# with ``csrc/flash_backward_plan.cuh``, plain C++: compiled here with the host
# compiler and called through ctypes, so the rules the card runs are the ones
# held.
PLAN_SHIM = """
#include "flash_backward_plan.cuh"
using namespace repro_torch::bwd_plan;
extern "C" {
int64_t plan_scratch(int B, int Sq, int Skv, int H, int KV, int dqk, int dv) {
  return scratch_floats(B, Sq, Skv, H, KV, dqk, dv);
}
int plan_subgroups(int B, int Sq, int Skv, int H, int KV, int causal, int q_offset, int slots) {
  return subgroups(B, Sq, Skv, H, KV, causal, q_offset, slots);
}
int plan_query_tiles(int t, int Sq, int causal, int q_offset) {
  return query_tiles(t, Sq, causal, q_offset);
}
}
"""
# (B, Sq, Skv, H, KV, dqk, dv, causal): the families' training calls, whisper's
# cross attention, MLA's prefill and shapes off the 64-row tile
PLAN_SHAPES = [(8, 1024, 1024, 14, 2, 64, 64, 1), (8, 1024, 1024, 32, 32, 80, 80, 1),
               (1, 768, 768, 48, 8, 128, 128, 1), (1, 64, 1500, 12, 12, 64, 64, 0),
               (1, 512, 512, 40, 40, 96, 64, 1), (3, 100, 164, 8, 2, 64, 64, 1),
               (2, 70, 90, 6, 6, 24, 16, 0), (1, 24, 24, 7, 1, 8, 8, 1),
               (1, 256, 256, 16, 1, 64, 64, 1)]


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan header")
    csrc = Path(tkernel.__file__).parent / "csrc"
    d = tmp_path_factory.mktemp("plan")
    (d / "shim.cpp").write_text(PLAN_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{csrc}", "-o",
                    str(d / "libplan.so"), str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.plan_scratch.restype = ctypes.c_int64
    return lib


def _longest_and_total(B, Sq, Skv, H, KV, causal, q_offset, lib):
    tiles = [lib.plan_query_tiles(t, Sq, causal, q_offset) for t in range(-(-Skv // 64))]
    return max(tiles), B * H * sum(tiles)


@pytest.mark.parametrize("q_offset", [0, 64, -40, 200])
@pytest.mark.parametrize("causal", [1, 0])
def test_plan_query_tiles_are_those_that_see_the_key_tile(plan, causal, q_offset):
    """Key tile t's query tiles: every 64-row tile from the first whose rows
    see one of its keys, by the masks of ``ref.mha_reference``."""
    Sq, Skv = 200, 330
    for t in range(-(-Skv // 64)):
        keys = np.arange(64 * t, min(64 * t + 64, Skv))
        rows = np.arange(Sq)
        sees = (keys[None, :] <= rows[:, None] + q_offset) if causal else \
            np.ones((Sq, keys.size), bool)
        first = np.flatnonzero(sees.any(axis=1))
        want = 0 if first.size == 0 else -(-Sq // 64) - first[0] // 64
        assert plan.plan_query_tiles(t, Sq, causal, q_offset) == want


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_scratch_holds_every_pass(plan, shape):
    """The scratch: lse in log2 units and Delta, each Sq rounded up to the
    64-row tile a (row, query head), so a tile's 64 values are one aligned
    copy; under GQA the f32 passes' fp32 dK | dV of every query head."""
    B, Sq, Skv, H, KV, dqk, dv, _ = shape
    rows = B * H * -(-Sq // 64) * 64
    want = 2 * rows + (0 if H == KV else B * Skv * H * (dqk + dv))
    assert plan.plan_scratch(B, Sq, Skv, H, KV, dqk, dv) == want
    assert rows % 64 == 0 and rows >= B * H * Sq


@pytest.mark.parametrize("slots", [264, 396, 132, 40])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_subgroups_are_the_fewest_that_balance_the_pass(plan, shape, slots):
    """The sub-groups of a KV head's G query heads: 1 without GQA; else the
    fewest s for which the longest block (ceil(G / s) heads times the most
    query tiles a key tile sees) walks no more tiles than an even share of
    the pass over ``slots`` blocks, or G when none does."""
    B, Sq, Skv, H, KV, _, _, causal = shape
    G = H // KV
    s = plan.plan_subgroups(B, Sq, Skv, H, KV, causal, 0, slots)
    longest, total = _longest_and_total(B, Sq, Skv, H, KV, causal, 0, plan)
    share = -(-total // slots)
    fits = [n for n in range(1, G) if -(-G // n) * longest <= share]
    assert 1 <= s <= G
    assert s == (1 if G == 1 else fits[0] if fits else G)
    assert plan.plan_subgroups(B, Sq, Skv, H, KV, causal, 0, 0) == 1


def test_plan_subgroups_at_the_training_calls(plan):
    """qwen2-0.5b's call (G 7) splits into 3 sub-groups at two blocks a SM
    of 132 SMs and 4 at three (the hd-64 pass's), internvl2-26b's (G 6, hd
    128, two blocks a SM) into 6; zamba2-2.7b (G 1) stays whole."""
    assert plan.plan_subgroups(8, 1024, 1024, 14, 2, 1, 0, 264) == 3
    assert plan.plan_subgroups(8, 1024, 1024, 14, 2, 1, 0, 396) == 4
    assert plan.plan_subgroups(1, 768, 768, 48, 8, 1, 0, 264) == 6
    assert plan.plan_subgroups(8, 1024, 1024, 32, 32, 1, 0, 264) == 1
