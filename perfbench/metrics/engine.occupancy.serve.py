"""Engine batching: the slots a decode step served, on average over the
window: the tokens the engine generated in the window, less its admissions'
first tokens, over its decode steps (``serving.tokens_generated`` and
``serving.decode_batches`` at the window's open and close)."""


def read(ctx):
    w = ctx["win"]
    if not w["decode_batches"]:
        return None
    admitted = sum(1 for r in w["records"] if r.request is not None
                   and r.request.first_token_at is not None
                   and w["t0"] <= r.request.first_token_at < w["t1"])
    return (w["tokens"] - admitted) / w["decode_batches"]
