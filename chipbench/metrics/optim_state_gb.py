"""optim_state_gb: the bytes of the AdamW state tensors the train step
holds and returns (``optim/optimizers.py``)."""


def read(ctx):
    n = ctx.get("optim_state_bytes")
    return n / 1e9 if n else None
