"""``pipeline.compute_sx``: SX_RADIUS<r>_AZIMUTH<a>, one plane."""

from portbench.outputs import Plane


def planes(args):
    az, radius, height = args["azimuth"], args["radius"], args.get("height", 10.0)
    return [Plane(f"SX_RADIUS{int(radius)}_AZIMUTH{int(az)}", "sx",
                  lambda r: r.sx(az, radius, height))]
