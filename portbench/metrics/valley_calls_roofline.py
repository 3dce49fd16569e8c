"""valley_calls_roofline: the least time one H100 needs for the window's
valley/ridge calls (the frozen work model, ``portbench/valley_work.py``:
per angle and flat one real-FFT convolution with the taps that reach the
grid, at the published float32 and HBM peaks) over the device time of
every kernel (copies left out) inside the harness's
``pb:compute_valley_ridge #`` spans, in percent: the whole op's share,
whichever kernels it launches. Silent without a trace or such kernels.
Moves out_mpix_s; read in basodino_30m.valley_streamed."""

from portbench import trace, valley_work

CALL = "compute_valley_ridge"


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels(within=lambda n: n.startswith(f"{trace.SPAN}{CALL} #"))
    busy = trace.busy_seconds((k.start, k.end) for k in kernels)
    least = valley_work.least_seconds(run, CALL)
    if busy <= 0 or least <= 0:
        return None
    return 100.0 * least / busy
