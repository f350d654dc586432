"""The port's logical-axis sharding against the JAX package's.

``resolve_spec`` is a pure function of the mesh's axis sizes, so both
packages resolve on a stand-in mesh that is only a ``shape`` dict: the
reference's resolution reads nothing else, and no devices are forced. For
every arch of ``ARCH_IDS`` (full configs: the reference's spec trees come
from ``jax.eval_shape``, the port's from a meta model) the weights', the
decode cache's, the optimizer state's and the batches' logical spec trees
equal the reference's, and every spec resolves to the reference's
PartitionSpec at 16x16, 2x16x16 and 2x4, with and without ``pure_dp``.
Then the port's own pieces: ``placements`` for joint and missing axes,
``shard_act`` as a no-op without a mesh, ``use_mesh`` nesting per thread.
"""
import contextlib
import threading
import types

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.sharding import partition as jax_partition  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import steps as jax_steps  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import steps  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
CACHE_B, CACHE_S = 8, 64


def _stand_in(axes: dict):
    return types.SimpleNamespace(shape=dict(axes))


@contextlib.contextmanager
def _jax_ctx(axes: dict, rules: dict):
    """The reference's thread-local mesh context on a stand-in mesh (its
    ``use_mesh`` would also enter the mesh as a jax context)."""
    prev = jax_partition.current()
    jax_partition._ctx.ctx = jax_partition.MeshContext(mesh=_stand_in(axes), rules=rules)
    try:
        yield jax_partition._ctx.ctx
    finally:
        jax_partition._ctx.ctx = prev


def _leaves(specs, avals, prefix=""):
    """(key, logical tuple, shape) of matching spec and stand-in trees."""
    if isinstance(specs, dict):
        out = []
        for k in sorted(specs):
            out += _leaves(specs[k], avals[k], f"{prefix}/{k}")
        return out
    return [(prefix, tuple(specs), tuple(avals.shape))]


def _as_dict(tree):
    return {k: _as_dict(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree)


@pytest.fixture(scope="module")
def jax_trees():
    """Per arch: the reference's weight specs and avals, and per mesh its
    cache specs and avals (``init_cache`` under the mesh, abstract)."""
    out = {}
    for arch in ARCH_IDS:
        m = JaxModel(jax_config(arch))
        caches = {}
        for name, axes in MESHES.items():
            captured = {}

            def f(m=m, captured=captured):
                c, s = m.init_cache(CACHE_B, CACHE_S)
                captured["s"] = s
                return c

            with _jax_ctx(axes, jax_partition.rules_for(m.cfg)):
                avals = jax.eval_shape(f)
            caches[name] = (captured["s"], avals)
        out[arch] = (m.specs(), m.abstract_params(), caches)
    return out


def test_the_archs_are_the_references():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weight_specs_equal_the_reference(arch, jax_trees):
    jspecs, javals, _ = jax_trees[arch]
    model = Model(get_config(arch), device="meta", kernel_impl="ref")
    assert _as_dict(model.specs()) == _as_dict(jspecs)
    avals = model.abstract_params()
    ours, theirs = _leaves(model.specs(), avals), _leaves(jspecs, javals)
    assert [(k, sh) for k, _, sh in ours] == [(k, sh) for k, _, sh in theirs]
    assert all(t.device.type == "meta" for t in opt.tree_leaves(avals))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh, jax_trees):
    jspecs, _ = jax_trees[arch][2][mesh]
    model = Model(get_config(arch), device="meta", kernel_impl="ref")
    with partition.use_mesh(_stand_in(MESHES[mesh]), partition.rules_for(model.cfg)):
        ours = model.cache_specs(CACHE_B, CACHE_S)
    assert _as_dict(ours) == _as_dict(jspecs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_specs_equal_the_reference(arch, jax_trees):
    jspecs = jax_trees[arch][0]
    model = Model(get_config(arch), device="meta", kernel_impl="ref")
    assert _as_dict(opt.state_specs(model.specs())) == _as_dict(jax_opt.state_specs(jspecs))


@pytest.mark.parametrize("pure_dp", [False, True], ids=["tp", "pure_dp"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_spec_resolves_as_the_reference(arch, mesh, pure_dp, jax_trees):
    """Weights, cache and every shape's batch, each resolved on both packages
    against the same axis sizes, give the same PartitionSpec."""
    jspecs, javals, caches = jax_trees[arch]
    cspecs, cavals = caches[mesh]
    cfg = get_config(arch).with_(pure_dp=pure_dp)
    jcfg = jax_config(arch).with_(pure_dp=pure_dp)
    axes = MESHES[mesh]
    ours_ctx = partition.MeshContext(_stand_in(axes), partition.rules_for(cfg))
    theirs_ctx = jax_partition.MeshContext(_stand_in(axes), jax_partition.rules_for(jcfg))
    leaves = _leaves(jspecs, javals) + _leaves(cspecs, cavals, "cache")
    for name in SHAPES:
        b_specs = steps.batch_logical_specs(cfg, SHAPES[name])
        assert b_specs == jax_steps.batch_logical_specs(jcfg, JAX_SHAPES[name])
        leaves += _leaves(b_specs, steps.batch_avals(cfg, SHAPES[name]), f"batch:{name}")
    assert len(leaves) > 10
    for key, logical, shape in leaves:
        want = jax_partition.resolve_spec(logical, shape, theirs_ctx)
        got = partition.resolve_spec(logical, shape, ours_ctx)
        assert tuple(got) == tuple(want), (key, logical, shape)
    # named_shardings resolves a whole tree the same way
    sh = partition.named_shardings(jspecs, javals, _stand_in(axes), partition.rules_for(cfg))
    assert tuple(sh["embed"]["tok"].spec) == tuple(
        jax_partition.resolve_spec(("vocab", "embed"), javals["embed"]["tok"].shape, theirs_ctx))


def test_resolve_spec_without_a_mesh_is_empty():
    assert partition.resolve_spec(("batch", "seq")) == partition.P()
    assert tuple(partition.resolve_spec(("batch", "vocab"), (8, 12),
                                        partition.MeshContext(None, {}))) == ()


def test_resolution_rules_by_hand():
    ctx = partition.MeshContext(_stand_in(MESHES["2x16x16"]), partition.rules_for())
    # joint batch over pod and data; 14 heads do not divide 16: replicated;
    # each mesh axis used once per spec; trailing Nones trimmed
    assert tuple(partition.resolve_spec(("batch", "seq", "heads", None), (64, 8, 14, 64),
                                        ctx)) == (("pod", "data"),)
    assert tuple(partition.resolve_spec(("embed", "mlp"), (896, 4864), ctx)) == (
        ("pod", "data"), "model")
    assert tuple(partition.resolve_spec(("vocab", "mlp"), (32, 32), ctx)) == ("model",)
    # 48 rows do not divide 32 (pod x data): the fallback candidate "data" takes them
    assert tuple(partition.resolve_spec(("batch",), (48,), ctx)) == ("data",)
    # a size-1 axis is skipped
    one = partition.MeshContext(_stand_in({"data": 1, "model": 4}), partition.rules_for())
    assert tuple(partition.resolve_spec(("batch", "heads"), (8, 8), one)) == (None, "model")


def test_placements_for_joint_and_missing_axes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _stand_in({"pod": 2, "data": 4, "model": 2})
    P = partition.P
    assert partition.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert partition.placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert partition.placements(P(), mesh) == (Replicate(),) * 3
    # an axis the mesh lacks places nothing
    two = _stand_in({"data": 2, "model": 2})
    assert partition.placements(P(("pod", "data"), "model"), two) == (Shard(0), Shard(1))
    assert partition.NamedSharding(two, P("model")).placements == (Replicate(), Shard(0))


def test_shard_act_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert partition.current() is None
    assert partition.shard_act(x, "batch", "seq", None) is x
    with partition.use_mesh(None):
        assert partition.shard_act(x, "batch", "seq", None) is x
    # a plain tensor under a mesh is not a DTensor: left as it is
    with partition.use_mesh(_stand_in(MESHES["2x4"])):
        assert partition.shard_act(x, "batch", "seq", None) is x


def test_use_mesh_nests_and_is_per_thread():
    a, b = _stand_in(MESHES["2x4"]), _stand_in(MESHES["16x16"])
    seen = {}
    with partition.use_mesh(a, {"batch": ("data",)}):
        assert partition.current().mesh is a
        with partition.use_mesh(b):
            assert partition.current().mesh is b
            assert partition.current().rules == partition.DEFAULT_RULES

            def other():
                seen["ctx"] = partition.current()

            t = threading.Thread(target=other)
            t.start()
            t.join()
        assert partition.current().mesh is a
        assert partition.current().rules == {"batch": ("data",)}
    assert partition.current() is None
    assert seen["ctx"] is None
