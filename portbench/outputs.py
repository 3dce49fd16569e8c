"""What each driver call must return, and how a returned plane is judged.

Each driver the cells call has a file ``portbench/drivers/<driver>.py``
whose ``planes(args)`` lists the call's planes: their names, in
MeteoSwiss/topo-descriptors' file naming (topo.py), which the drivers keep,
each with the plain reference's plane (``reference.descriptors.Reference``)
and the kind it is judged under.
Each kind gives two numbers, over the pixels finite on both sides:

* ``<kind>_max``: the largest ``|program - reference|`` of any of its
  planes, over the largest ``|reference|`` of any of its planes;
* ``<kind>_rms``: the largest root-mean-square gap of any of its planes,
  over the largest root-mean-square reference of any of its planes.

Both divide by one scale per kind, not one per plane: a gradient at 100 km
is nearly flat, and float32 rounding of the smoothed elevations, small
against the elevations, is large against its own tiny maximum. For aspect,
a direction that flat ground leaves ill-defined, the gap is the distance
between the two unit directions times the reference's gradient magnitude,
over the magnitude. ``nan_mismatch`` counts the pixels that are NaN on
one side only; its limit is 0.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

HERE = Path(__file__).resolve().parent
NAN_MISMATCH = "nan_mismatch"


@dataclass
class Plane:
    name: str
    kind: str  # the kind whose numbers it counts under
    reference: Callable  # Reference -> (H, W) tensor
    weight: Optional[Callable] = None  # Reference -> (H, W) weights of a plane of directions


def listed(value, length=None) -> list:
    """A driver argument as a list; a scalar repeats ``length`` times."""
    if hasattr(value, "__iter__") and not isinstance(value, str):
        return list(value)
    return [value] * (length or 1)


def expected(call: str, args: dict) -> list:
    """The planes of one driver call, in the order the driver returns them:
    ``portbench/drivers/<call>.py``'s ``planes(args)``."""
    path = HERE / "drivers" / f"{call}.py"
    if not path.is_file():
        raise ValueError(f"no reference for driver {call!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{call}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.planes(args)


def numbers_of(kind: str) -> tuple:
    return f"{kind}_max", f"{kind}_rms"


def _gap(program, ref, weight):
    """(pixels NaN on one side only, the gap at each pixel finite on both
    sides); a weighted plane holds directions in degrees."""
    p_nan, r_nan = torch.isnan(program), torch.isnan(ref)
    both = ~p_nan & ~r_nan
    if weight is not None:
        turn = torch.deg2rad(program - ref)[both]
        return int((p_nan != r_nan).sum()), weight[both] * 2 * torch.abs(torch.sin(turn / 2))
    return int((p_nan != r_nan).sum()), (program - ref)[both].abs()


def _rms(t: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(t * t))) if t.numel() else 0.0


def judge(planes_by_name: dict, kept: list, reference, device) -> tuple:
    """``(numbers, per call)`` over the kept ``(call id, name, array)``
    planes against ``reference``: each number of each kind present, and
    for each call the same numbers over its own planes."""
    refs = {}
    for _, name, _ in kept:
        if name not in refs:
            spec = planes_by_name[name]
            refs[name] = (spec.reference(reference),
                          spec.weight(reference) if spec.weight else None)
    scale_max, scale_rms = {}, {}
    for name, (ref, weight) in refs.items():
        kind = planes_by_name[name].kind
        size = ref.abs() if weight is None else weight
        size = size[~torch.isnan(size)]
        if size.numel():
            scale_max[kind] = max(scale_max.get(kind, 0.0), float(size.max()))
            scale_rms[kind] = max(scale_rms.get(kind, 0.0), _rms(size))
    numbers, per_call = {NAN_MISMATCH: 0}, {}
    for call_id, name, array in kept:
        kind = planes_by_name[name].kind
        ref, weight = refs[name]
        program = torch.as_tensor(array, device=device).to(torch.float64)
        mismatch, gap = _gap(program, ref, weight)
        n_max, n_rms = numbers_of(kind)
        found = {NAN_MISMATCH: mismatch,
                 n_max: float(gap.max()) / max(scale_max.get(kind, 0.0), 1e-300)
                 if gap.numel() else 0.0,
                 n_rms: _rms(gap) / max(scale_rms.get(kind, 0.0), 1e-300)}
        call = per_call.setdefault(call_id, {NAN_MISMATCH: 0})
        for n, v in found.items():
            if n == NAN_MISMATCH:
                numbers[n] += v
                call[n] += v
            else:
                numbers[n] = max(numbers.get(n, 0.0), v)
                call[n] = max(call.get(n, 0.0), v)
    return numbers, per_call
