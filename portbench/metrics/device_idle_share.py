"""device_idle_share: 1 - (union of the device's activity intervals) / the
traced window, from torch.profiler's events.
Moves out_mpix_s; read in every cell."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
