"""``pipeline.compute_tpi``: TPI_<scale>M[_SMTHFACT<f>] per scale."""

from portbench.outputs import Plane, listed


def planes(args):
    scales = listed(args["scales"])
    factors = listed(args.get("smth_factors"), len(scales))
    return [Plane(f"TPI_{s}M" + (f"_SMTHFACT{f:.3g}" if f else ""), "tpi",
                  lambda r, s=s, f=f: r.tpi(s, f)) for s, f in zip(scales, factors)]
