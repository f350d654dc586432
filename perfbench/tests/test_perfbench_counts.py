"""The copied arithmetic reproduces the figures PERF.md records for it."""
import pytest

from perfbench import counts
from perfbench.bench import resolve


def _specs(workload):
    cell = resolve(workload)
    return cell.reference().weight_specs(cell.model), cell.model


def test_qwen2_moe_decode_step_reads_4_762_gb_of_weights():
    specs, m = _specs("moe-chat")
    assert counts.step_weight_bytes(specs, m) / 1e9 == pytest.approx(4.762, abs=5e-4)


def test_decode_attention_bytes_count_keys_q_o_and_lengths():
    m = {"n_heads": 16, "n_kv_heads": 16, "d_model": 2048}
    # one row over 10 keys: K and V rows, q and o, one int32 length
    assert counts.decode_attention_bytes([10], m) == (10 * 16 + 16) * 256 * 2 + 4


def test_least_time_takes_the_larger_bound():
    assert counts.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert counts.least_ms(0, 989e9) == pytest.approx(1.0)
    assert counts.idle_share(0.25, 1.0) == 0.75
