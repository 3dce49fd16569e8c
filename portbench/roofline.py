"""Roofline shares of the window's calls: the least time of their work
(``work.py``) over the device time of the kernels that did it (the union
of their intervals in the trace), in percent."""

from __future__ import annotations

import json

from portbench import trace, work
from portbench.reference import geometry


def least_seconds(run, call: str) -> float:
    """Least time of every completed ``call`` of the window: per TPI plane
    one middle-less disk convolution, per Sx plane the call's rays."""
    h, w = run.shape
    crs = run.config["grid"]["crs"]
    rx, ry = geometry.resolution(run.x, run.y, crs)
    per_args, total = {}, 0.0
    for c in run.calls:
        if c.call != call or c.error:
            continue
        key = json.dumps(c.args, sort_keys=True)
        if key not in per_args:
            if call == "compute_tpi":
                sizes = geometry.scale_to_pixel(c.args["scales"], run.x, run.y, crs)
                per_args[key] = sum(work.least_seconds(*work.tpi_work(h, w, int(px)))
                                    for px in sizes)
            elif call == "compute_sx":
                per_args[key] = work.least_seconds(*work.sx_call_work(
                    h, w, c.args["azimuth"], c.args["radius"], float(rx.mean()), float(ry.mean())))
            else:
                raise ValueError(f"no work model for {call}")
        total += per_args[key]
    return total


def share(run, call: str, kernel_name=None):
    """Percent of the least time of ``call``'s work in the device time of
    the kernels whose name ``kernel_name`` accepts, or, without it, of every
    kernel inside ``call``'s spans. None without a trace or such kernels."""
    if run.trace is None:
        return None
    if kernel_name is None:
        kernels = run.trace.kernels(within=lambda n: n.startswith(f"{trace.SPAN}{call} #"))
    else:
        kernels = [k for k in run.trace.kernels() if kernel_name(k.name)]
    busy = trace.busy_seconds((k.start, k.end) for k in kernels)
    least = least_seconds(run, call)
    if busy <= 0 or least <= 0:
        return None
    return 100.0 * least / busy
