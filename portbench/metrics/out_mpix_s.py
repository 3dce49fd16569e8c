"""out_mpix_s: Mpixel of output planes that the drivers returned in the
window, over the window's seconds (all the work of whole jobs over all
their time)."""


def read(run):
    pixels = sum(c.pixels for c in run.calls if not c.error)
    return pixels / run.window_s / 1e6 if run.window_s > 0 else None
