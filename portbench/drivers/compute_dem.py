"""``pipeline.compute_dem``: DEM_<scale>M, the smoothed DEM per scale."""

from portbench.outputs import Plane, listed


def planes(args):
    return [Plane(f"DEM_{s}M", "dem", lambda r, s=s: r.dem(s)) for s in listed(args["scales"])]
