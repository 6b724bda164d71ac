"""swiglu_roofline: the fused SwiGLU kernel's share of its roofline
(``kernels/fused_swiglu``): the dense form at every MLP application, or
the expert form at every MoE layer, all experts' capacity slots of the
micro-batch's groups in one launch."""

import math

from chipbench import yardstick
from chipbench.metrics._kernels import roofline, rows_per_micro


def read(ctx):
    c = ctx["config"]
    rows, s, d = rows_per_micro(ctx), ctx["seq_len"], c["d_model"]
    if c["family"] == "moe":
        group = min(c["moe_group_tokens"], s)
        cap = max(math.ceil(group * c["top_k"] / c["n_experts"]
                            * c["capacity_factor"]), 1)
        cost = yardstick.swiglu_launch(c["n_experts"],
                                       rows * s // group * cap, d,
                                       c["moe_d_ff"], c["dtype"])
        apps = c["n_layers"]
    else:
        cost = yardstick.swiglu_launch(1, rows * s, d, c["d_ff"], c["dtype"])
        apps = c["n_layers"] // c["shared_attn_every"] \
            if c["family"] == "hybrid" else c["n_layers"]
    return roofline(ctx, "swiglu", ("swiglu",), cost, c["dtype"], apps)
