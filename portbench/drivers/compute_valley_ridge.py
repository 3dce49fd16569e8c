"""``pipeline.compute_valley_ridge``: <MODE>_NORM_<scale>M[_SMTHFACT<f>] then
<MODE>_DIR_..., per scale. The norms count as kind ``vr_norm``; a direction
counts as kind ``vr_dir``, weighted by the reference's lead (the winning
response less the best response at any other angle), so a gap is the lead
times the chord of the angle gap: a rounding near-tie reads small, a wrong
direction where one angle clearly wins reads large."""

from portbench.outputs import Plane, listed
from portbench.reference import valley_ridge


def planes(args):
    scales = listed(args["scales"])
    factors = listed(args.get("smth_factors"), len(scales))
    mode, flats = args["mode"], tuple(args.get("flat_list", (0, 0.15, 0.3)))
    out = []
    for s, f in zip(scales, factors):
        add = f"_SMTHFACT{f:.3g}" if f else ""

        def of(r, s=s, f=f):
            return valley_ridge.index(r, s, mode, flats, f)

        out += [Plane(f"{mode.upper()}_NORM_{s}M{add}", "vr_norm", lambda r, of=of: of(r)["norm"]),
                Plane(f"{mode.upper()}_DIR_{s}M{add}", "vr_dir",
                      lambda r, of=of: of(r)["direction"], lambda r, of=of: of(r)["lead"])]
    return out
