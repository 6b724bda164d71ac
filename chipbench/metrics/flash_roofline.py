"""flash_roofline: the flash attention forward kernel's share of its
roofline (``kernels/flash_attention``), every attention application of a
step at the cell's shapes."""

from chipbench import yardstick
from chipbench.metrics._kernels import roofline, rows_per_micro


def read(ctx):
    c = ctx["config"]
    apps = c["n_layers"] // c["shared_attn_every"] \
        if c["family"] == "hybrid" else c["n_layers"]
    s = ctx["seq_len"]
    cost = yardstick.flash_launch(rows_per_micro(ctx), c["n_heads"],
                                  c["n_kv_heads"], s, s, c["head_dim"],
                                  True, c["dtype"])
    return roofline(ctx, "flash", ("flash_fwd",), cost, c["dtype"], apps)
