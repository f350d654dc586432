"""The port's copied configs equal the JAX package's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402

PORTED = ("qwen2-0.5b", "qwen1.5-0.5b", "deepseek-67b", "mamba2-2.7b", "zamba2-2.7b",
          "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "minicpm3-4b", "whisper-small",
          "internvl2-26b")


def test_port_lists_exactly_the_ported_archs():
    assert torch_configs.ARCH_IDS == tuple(sorted(PORTED))


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference(arch, which):
    ours = getattr(torch_configs, which)(arch)
    theirs = getattr(jax_configs, which)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if theirs.n_heads:  # attention-free families (ssm) have no head_dim
        assert ours.hd == theirs.hd
    assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-large-v3", "no-such"])
def test_unported_arch_raises_clear_keyerror(arch):
    with pytest.raises(KeyError, match="not ported to repro_torch"):
        torch_configs.get_config(arch)
    with pytest.raises(KeyError, match="not ported to repro_torch"):
        torch_configs.get_reduced(arch)
