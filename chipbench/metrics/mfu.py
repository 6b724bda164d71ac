"""mfu: the train step's model FLOPs (``_model_flops.py``, from the
configuration's widths) of the steps completed in the window, over the
window's time times the cards times the card's bf16 peak."""

from chipbench import yardstick
from chipbench.metrics._model_flops import train_step_flops


def read(ctx):
    if ctx["card"] not in yardstick.PEAKS or not ctx["steps_done"]:
        return None
    flops = train_step_flops(ctx["config"], ctx["seq_len"],
                             ctx["sequences"]) * ctx["steps_done"]
    peak = yardstick.peaks(ctx["card"])["bfloat16"]
    return 100 * flops / (ctx["window_s"] * ctx["chips"] * peak)
