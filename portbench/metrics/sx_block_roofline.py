"""sx_block_roofline: the least time one H100 needs for the window's Sx
planes (the frozen work model, ``portbench/work.py``, over each call's
distinct ray pixels) over the device time of the ``sx_block`` kernels, in
percent. Silent where no such kernel ran.
Moves out_mpix_s; read in alps_tile_8192_30m.tpi_sx."""

from portbench.roofline import share


def read(run):
    return share(run, "compute_sx", lambda name: "sx_block" in name)
