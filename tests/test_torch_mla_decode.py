"""MLA's absorbed decode attention (``ops.mla_decode_attention``) on the CPU.

The op reads K = [ckv | krope] and V = ckv from the model's two latent caches
as they lie (models/mla.py); on CPU tensors it runs its plain version. Held
here, at minicpm3-4b's widths (a latent of 256 and a rope part of 32, 40 query
heads over the one latent KV head, scale 96^-0.5) on short caches:

- the op against the JAX package's ``decode_attention_reference`` on the
  concatenated cache, what src/repro/models/mla.py:131-134 runs, with scalar
  and per-row positions, f32 within 1e-5; only rows with a key are compared
  (a row with none gives zeros in the port and the mean of V in JAX, F6);
- the plain partials over 2 and 4 sequence shards, merged by
  ``ref.combine_partials``, equal the whole;
- the kernel wrapper's checks on CPU tensors (widths, dtypes, one token),
  ``impl="kernel"`` refusing a CPU tensor, and the wrapper on CPU tensors
  computing the plain version with no launch counted.

The kernel itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

H, DL, DR = 40, 256, 32
SCALE = 96 ** -0.5
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _inputs(B, S, dtype=torch.float32, seed=0, h=H, dl=DL, dr=DR):
    """q (B, 1, h, dl + dr), ckv (B, S, dl), krope (B, S, dr), standard normal."""
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((B, 1, h, dl + dr), (B, S, dl), (B, S, dr))]


POSITIONS = {"scalar-mid": 11, "scalar-last": 39, "vector": [-1, 0, 17, 39]}


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("which", list(POSITIONS))
def test_op_matches_the_jax_reference_on_the_concatenated_cache(which, impl):
    q, ckv, krope = _inputs(4, 40)
    pos = POSITIONS[which]
    got = ops.mla_decode_attention(q, ckv, krope, torch.tensor(pos), scale=SCALE, impl=impl)
    assert got.shape == (4, 1, H, DL) and got.dtype == torch.float32
    k_full = np.concatenate([ckv.numpy(), krope.numpy()], axis=-1)[:, :, None, :]
    want = np.asarray(jax_ref.decode_attention_reference(
        jnp.asarray(q.numpy()), jnp.asarray(k_full), jnp.asarray(ckv.numpy()[:, :, None, :]),
        jnp.asarray(pos), scale=SCALE))
    rows = np.flatnonzero(np.broadcast_to(np.asarray(pos), (4,)) >= 0)
    np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=1e-5, atol=1e-5)
    if which == "vector":                     # the row of length 0: zeros
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shards", [2, 4])
def test_plain_partials_over_sequence_shards_merge_to_the_whole(shards, dtype):
    q, ckv, krope = _inputs(4, 64, dtype, seed=1)
    pos = torch.tensor([10, -1, 63, 37])      # ends in the first shard; length 0; full; mid
    L = 64 // shards
    parts = [ref.mla_decode_partials_reference(q, ckv[:, i * L:(i + 1) * L],
                                               krope[:, i * L:(i + 1) * L], pos,
                                               pos_offset=i * L, scale=SCALE)
             for i in range(shards)]
    m, l, acc = parts[-1]                     # rows with no position in the last shard
    assert torch.isneginf(m[:2]).all() and (l[:2] == 0).all() and (acc[:2] == 0).all()
    whole = ops.mla_decode_attention(q, ckv, krope, pos, scale=SCALE)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(ref.combine_partials(parts, dtype).float(), whole.float(),
                               rtol=tol, atol=tol)
    # and through the wrapper of the partials kernel, which takes the plain
    # version for CPU tensors
    got = kernel.mla_decode_attention_partials(q, ckv[:, :L], krope[:, :L], pos, scale=SCALE)
    for g, w in zip(got, parts[0]):
        assert torch.equal(g, w)


BAD = {  # name: (B, S, h, dl, dr, what is changed, the message)
    "latent-not-a-multiple-of-16": ((2, 8, 4, 24, 8), None, "multiple of 16"),
    "rope-not-a-multiple-of-8": ((2, 8, 4, 16, 4), None, "multiple of 8"),
    "latent-too-wide": ((2, 8, 4, 272, 8), None, "up to 256"),
    "rope-too-wide": ((2, 8, 4, 16, 72), None, "up to 64"),
    "q-not-the-widths-sum": ((2, 8, 4, 16, 8), "q", "widths' sum"),
    "caches-differ-in-length": ((2, 8, 4, 16, 8), "krope", "the same \\(B, S\\)"),
    "dtypes-differ": ((2, 8, 4, 16, 8), "dtype", "has dtype"),
    "float16": ((2, 8, 4, 16, 8), "half", "float32 or bfloat16"),
    "two-query-tokens": ((2, 8, 4, 16, 8), "tokens", "one query token"),
    "cpu-tensors": ((2, 8, 4, 16, 8), None, "must be a CUDA tensor"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(case):
    (B, S, h, dl, dr), change, msg = BAD[case]
    q, ckv, krope = _inputs(B, S, h=h, dl=dl, dr=dr)
    if change == "q":
        q = q[..., :-8]
    elif change == "krope":
        krope = krope[:, :-1]
    elif change == "dtype":
        krope = krope.bfloat16()
    elif change == "half":
        q, ckv, krope = q.half(), ckv.half(), krope.half()
    elif change == "tokens":
        q = q.expand(B, 2, h, dl + dr)
    with pytest.raises(ValueError, match=msg):
        kernel._check_mla(q, ckv, krope)


def test_kernel_impl_refuses_cpu_tensors_and_the_wrapper_runs_the_plain_version():
    q, ckv, krope = _inputs(2, 16, h=4, dl=16, dr=8)
    pos = torch.tensor([3, 15])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.mla_decode_attention(q, ckv, krope, pos, scale=SCALE, impl="kernel")
    before = dict(kernel.LAUNCHES)
    got = kernel.mla_decode_attention(q, ckv, krope, pos, scale=SCALE)
    assert kernel.LAUNCHES == before           # no kernel ran
    assert torch.equal(got, ref.mla_decode_reference(q, ckv, krope, pos, scale=SCALE))
