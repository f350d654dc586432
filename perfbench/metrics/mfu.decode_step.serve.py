"""The decode step's share of the card's peak: the least time of each
replayed step by bytes, at HBM's rate (the weights a step reads at least,
``counts.step_weight_bytes``; each decode-attention call's K/V at the rows'
positions; a Mamba2 layer's state read and written), over its device time by
CUDA events, summed over the window's replays."""
from perfbench import counts


def read(ctx):
    replays = ctx["win"].get("replays") or []
    if not replays:
        return None
    m = ctx["cell"].model
    fixed = counts.step_weight_bytes(ctx["specs"], m)
    calls = counts.attention_calls(m)
    bound = sum(counts.least_ms(fixed + calls * counts.decode_attention_bytes(k, m)
                                + counts.decode_state_bytes(m, len(k)), 0)
                for _, k in replays)
    return 100.0 * bound / sum(ms for ms, _ in replays)
