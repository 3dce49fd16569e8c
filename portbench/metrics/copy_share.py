"""copy_share: the union of host<->device copy intervals over the traced
window (the drivers' uploads and downloads).
Moves out_mpix_s; read in alps_tile_8192_30m.tpi_sx."""

from portbench.trace import busy_seconds


def read(run):
    if run.trace is None:
        return None
    copies = [(e.start, e.end) for e in run.trace.device if e.kind == "copy"]
    return busy_seconds(copies) / run.trace.window_s if copies else None
