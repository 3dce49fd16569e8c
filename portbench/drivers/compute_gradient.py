"""``pipeline.compute_gradient``: WE_DERIVATIVE, SN_DERIVATIVE, SLOPE and
ASPECT per scale; the derivatives count as kind ``grad``, aspect is
weighted by the reference's gradient magnitude."""

import torch

from portbench.outputs import Plane, listed

KINDS = (("WE_DERIVATIVE", "grad"), ("SN_DERIVATIVE", "grad"), ("SLOPE", "slope"),
         ("ASPECT", "aspect"))


def planes(args):
    scales = listed(args["scales"])
    ratios = listed(args.get("sig_ratios", 1), len(scales))
    return [Plane(f"{name}_{s}M_SIGRATIO{q:.3g}", kind,
                  lambda r, s=s, q=q, i=i: r.gradient(s, q)[i],
                  (lambda r, s=s, q=q: torch.hypot(*r.gradient(s, q)[:2]))
                  if kind == "aspect" else None)
            for s, q in zip(scales, ratios) for i, (name, kind) in enumerate(KINDS)]
