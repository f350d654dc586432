"""Decode attention over a cache sharded by sequence, with no gather (F14, B12).

On a mesh whose `model` axis the KV heads do not divide, the port keeps the
reference's sequence-sharded (``seq_shard``) decode cache, and MLA's latent
cache is always so. Each rank then runs ``decode_attention_partials`` over its
own positions and two all-reduces merge the partials by log-sum-exp:

- the plain partials of 2 and 4 shards, merged, equal
  ``decode_attention_reference`` on the whole cache, at a GQA and an MLA
  shape, with a row that ends in the first shard (later shards empty) and a
  row of length 0;
- on two gloo ranks (a (1, 2) mesh, the ranks in child processes) the sharded
  decode steps of a GQA config whose one KV head cannot split over `model` and
  of an MLA config equal the unsharded steps: logits within 3e-4 (f32, the
  reference's decode tolerance, tests/test_decode_equivalence.py) and the same
  greedy tokens, with rows that cross the shards' boundary;
- the dry run of qwen2-0.5b ``decode_32k`` on 2x4 (PyTorch's fake process
  group) gathers no cache: its all-gathers are the weights', its wire bytes
  at most twice the reference's 3.1070e8 a device, and its bound is not the
  collective term.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402
from test_torch_mesh import _model, _spawn  # noqa: E402

DECODE_TOL = 3e-4
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SHAPES = {  # B, S, H, KV, dqk, dv
    "gqa": (4, 64, 14, 2, 64, 64),
    "mla": (4, 64, 8, 1, 40, 32),
}
POS = [10, -1, 63, 37]   # ends in the first shard of 2 and of 4; length 0; full; mid


def _inputs(shape, dtype, seed=0):
    B, S, H, KV, dqk, dv = shape
    r = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(dtype)  # noqa: E731
    return mk(B, 1, H, dqk), mk(B, S, KV, dqk), mk(B, S, KV, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_partials_merged_equal_the_whole_cache(name, shards, dtype):
    q, k, v = _inputs(SHAPES[name], dtype)
    pos = torch.tensor(POS)
    L = k.shape[1] // shards
    parts = [ref.decode_attention_partials_reference(q, k[:, i * L:(i + 1) * L],
                                                     v[:, i * L:(i + 1) * L], pos,
                                                     pos_offset=i * L)
             for i in range(shards)]
    # a row whose positions all lie in another shard: m = -inf, l = 0, acc = 0
    m, l, acc = parts[-1]
    assert torch.isneginf(m[0]).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    assert torch.isneginf(m[1]).all() and (l[1] == 0).all()
    got = ref.combine_partials(parts, q.dtype)
    want = ref.decode_attention_reference(q, k, v, pos)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    assert (got[1] == 0).all()   # length 0: zeros (F6's rule)


def test_plain_partials_at_a_scalar_position():
    q, k, v = _inputs(SHAPES["gqa"], torch.float32)
    parts = [ref.decode_attention_partials_reference(q, k[:, i * 16:(i + 1) * 16],
                                                     v[:, i * 16:(i + 1) * 16], torch.tensor(20),
                                                     pos_offset=i * 16) for i in range(4)]
    torch.testing.assert_close(ref.combine_partials(parts, q.dtype),
                               ref.decode_attention_reference(q, k, v, torch.tensor(20)),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- two ranks
def _config(arch):
    from repro_torch.configs import get_reduced

    cfg = get_reduced(arch).with_(dtype="float32")
    return cfg.with_(n_kv_heads=1) if cfg.mla is None else cfg


def _decode_on_two_ranks(rank, arch):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blocks import decoder_cache_specs
    from repro_torch.sharding import partition
    from repro_torch.training import steps

    cfg = _config(arch)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    with partition.use_mesh(mesh, partition.rules_for(cfg)):
        specs = decoder_cache_specs(cfg)
    rng = np.random.default_rng(1)
    start = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32))
    first = torch.tensor([0, 3, 10, 13])   # S = 24: rows cross position 12, the shards' boundary

    def run(mesh):
        model = _model(cfg)
        built = steps.build_decode_step(model, mesh=mesh)
        logits = []
        decode = model.decode_step

        def recorded(*a):
            out, cache = decode(*a)
            logits.append(out.full_tensor() if hasattr(out, "full_tensor") else out)
            return out, cache

        model.decode_step = recorded
        cache = model.init_cache(4, 24)
        placed = []
        if mesh is not None:
            cache = steps.place_cache(model, cache, mesh)
            placed = [(tuple(t.shape), tuple(t.placements)) for t in _leaves(cache)]
        token, tokens = start, []
        for i in range(8):
            token, cache = built.fn(model.params, token, cache, first + i)
            token = token.full_tensor() if hasattr(token, "full_tensor") else token
            tokens.append(token[:, 0].tolist())
        return torch.stack(logits).numpy(), tokens, placed

    want, want_tokens, _ = run(None)
    got, got_tokens, placed = run(mesh)
    # every cache leaf (layers, B, S, ...) is split over `model` by its sequence
    seq_sharded = all(pl[1].is_shard(dim=2) and shape[2] == 24 for shape, pl in placed)
    return {"err": float(np.abs(got - want).max()), "tokens": (want_tokens, got_tokens),
            "specs": specs, "seq_sharded": seq_sharded and bool(placed), "placed": str(placed)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "minicpm3-4b"], ids=["gqa-kv1", "mla"])
def test_two_rank_decode_over_a_sequence_sharded_cache(tmp_path, arch):
    r = _spawn(tmp_path, 2, _decode_on_two_ranks, arch)
    assert all(s[1] == "seq_shard" for s in r["specs"].values()), r["specs"]
    assert r["seq_sharded"], r["placed"]
    assert r["err"] <= DECODE_TOL, r
    assert r["tokens"][0] == r["tokens"][1]


# ------------------------------------------------------------------ dry run
def test_dryrun_decode_32k_gathers_no_cache(tmp_path):
    from repro_torch.configs import SHAPES as CELLS, get_config
    from repro_torch.launch import dryrun

    rec = dryrun.run_mesh_cell_subprocess("qwen2-0.5b", "decode_32k", (2, 4),
                                          full_depth=False, timeout=600)
    assert rec["status"] == "ok", rec
    cfg, shape = get_config("qwen2-0.5b"), CELLS["decode_32k"]
    # one layer's K shard on a device (batch over data, 2; sequence over model,
    # 4): gathering K and V would add 8x this a layer (816 MB before the repair)
    k_shard = (shape.global_batch // 2) * (shape.seq_len // 4) * cfg.n_kv_heads * cfg.hd * 2
    cal = rec["analysis"]["calibrated"]
    gathered = (cal["collectives_delta"]["result_bytes"].get("all-gather", 0)
                - cal["collectives_base"]["result_bytes"].get("all-gather", 0))
    assert gathered < k_shard / 4, (gathered, k_shard)
    assert rec["analysis"]["cost"]["wire_bytes_per_device"] <= 2 * 3.1070e8
    assert rec["analysis"]["roofline"]["bottleneck"] != "collective"
