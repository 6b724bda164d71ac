"""device_idle_share: the share of the steady steps traced after the
window, with only the card's activity recorded, in which no kernel and no
copy ran on the card (``chipbench/trace.py``)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx["cuda"] or tr["busy_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
