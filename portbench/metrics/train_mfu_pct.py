"""The whole step's share of the H100's published peaks: the least time
the window's rounds need (roofline/step_<model>.py, the larger of the f32
operations over 67 TFLOP/s and the bytes over 3.35 TB/s) over the
window's time.  The card's power limit is printed beside it."""

import importlib


def read(ctx):
    step = importlib.import_module(f"portbench.roofline.step_{ctx.cfg['model']}")
    least = ctx.rounds * step.round_seconds(ctx.conf, ctx.data)
    ctx.note(f"train_mfu_pct: least {least:.6f} s for {ctx.rounds} rounds over a "
             f"{ctx.window_s:.6f} s window, card power limit {ctx.power_limit}")
    return 100.0 * least / ctx.window_s
