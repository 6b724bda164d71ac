"""remat_kept_gb: the bytes the checkpoint policy (``core/remat.py``,
``observe_regions``) keeps on the card for one micro-batch's backward:
every region's input and kept tensors, summed over the micro-batch's
regions (all held at once when its forward ends), the mean over the
traced micro-batches."""


def read(ctx):
    regions = ctx.get("regions")
    micro = ctx["microbatches"] * ctx["steps_traced"]
    if not regions or not micro:
        return None
    kept = sum(r.input_bytes + sum(r.kept.values()) for r in regions)
    return kept / micro / 1e9
