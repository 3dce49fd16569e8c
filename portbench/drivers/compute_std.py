"""``pipeline.compute_std``: STD_<scale>M[_SMTHFACT<f>] per scale."""

from portbench.outputs import Plane, listed


def planes(args):
    scales = listed(args["scales"])
    factors = listed(args.get("smth_factors"), len(scales))
    return [Plane(f"STD_{s}M" + (f"_SMTHFACT{f:.3g}" if f else ""), "std",
                  lambda r, s=s, f=f: r.std(s, f)) for s, f in zip(scales, factors)]
