"""copy_gbps: the bytes the program copied between host and card over the
window (``device.COPIED_BYTES``, host-to-device and device-to-host) over
the summed device time of the window's ``Memcpy HtoD`` and ``Memcpy DtoH``
events, in GB/s: the copies' own rate. Silent where the program keeps no
such counter or the trace holds no such copy.
Moves out_mpix_s; read in alps_tile_8192_30m.tpi_sx."""

COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def counters():
    from topo_descriptors_tpu_torch import device

    return dict(getattr(device, "COPIED_BYTES", {}))


def read(run):
    moved = sum(run.counters.get("copy_gbps", {}).values())
    if run.trace is None or not moved:
        return None
    ns = sum(e.end - e.start for e in run.trace.device if e.name.startswith(COPIES))
    return moved / ns if ns else None
