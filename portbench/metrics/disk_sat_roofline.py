"""disk_sat_roofline: the least time one H100 needs for the window's TPI
convolutions (the frozen work model, ``portbench/work.py``: one 'same'
convolution with the middle-less disk per TPI plane, at the published
float32 and HBM peaks) over the device time of the ``disk_sat`` kernels,
in percent. Silent where no such kernel ran.
Moves out_mpix_s; read in alps_tile_8192_30m.tpi_sx."""

from portbench.roofline import share


def read(run):
    return share(run, "compute_tpi", lambda name: "disk_sat" in name)
