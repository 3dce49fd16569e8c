"""tpi_calls_roofline: the same least time as disk_sat_roofline over the
device time of every kernel (copies left out) inside the TPI driver calls,
in percent: the whole op's share, whichever kernels it launches.
Moves out_mpix_s; read in alps_tile_8192_30m.tpi_sx."""

from portbench.roofline import share


def read(run):
    return share(run, "compute_tpi", None)
