"""Faults planted underneath a run's timed path, to see that the check which
decides ``correct`` catches them. One for each fault a one-chip cell can
have (it has no exchange between chips to leave out):

* ``state_unchanged``: the TPI and fused disk ops hand back their input
  field unchanged, and the valley engine hands it back as its index, with
  every direction 0;
* ``half_left_out``: the disk sums skip every other kernel row and double
  what is left: half of each neighbourhood left out, its mean taken over
  the rest (on the card the halved disk still runs through the kernels);
  the valley engine leaves out the later half of the flat fractions and
  takes its maximum over the rest;
* ``answer_altered``: every plane that comes back to the host has one
  pixel off by one unit (1 m, 1 degree), where the driver produces it.

``planted(name)`` patches the program for the length of a ``with`` block.
The benchmark's own runs never import this module.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch


def _state_unchanged(patch):
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.device import as_field

    patch(ops, "tpi", lambda dem, size, sigma=None, device="cuda", **k: as_field(dem, device))

    def disk_descriptors(dem, sizes, sigma=None, compute_tpi=True, compute_std=True,
                         device="cuda", **k):
        field = as_field(dem, device)
        stack = torch.stack([field] * len(sizes))
        return {n: stack for n, on in (("tpi", compute_tpi), ("std", compute_std)) if on}

    patch(ops, "disk_descriptors", disk_descriptors)

    def valley_ridge(dem, size, mode, flat_list=(0, 0.15, 0.3), sigma=None, device="cuda", **k):
        field = as_field(dem, device)
        return [field, torch.zeros_like(field)]

    patch(ops, "valley_ridge", valley_ridge)


def _half_left_out(patch):
    from topo_descriptors_tpu_torch import ops

    for name in ("tpi", "std", "multiscale"):
        module = importlib.import_module(f"topo_descriptors_tpu_torch.ops.{name}")
        for fn in ("conv2d_same", "conv2d_same_multi"):
            if hasattr(module, fn):
                original = getattr(module, fn)

                def halved(x, kernel, *a, _original=original, **k):
                    kernel = np.array(kernel)
                    kernel[1::2] = 0
                    return 2 * _original(x, kernel, *a, **k)

                patch(module, fn, halved)

    original = ops.valley_ridge

    def valley_ridge(dem, size, mode, flat_list=(0, 0.15, 0.3), *a, **k):
        return original(dem, size, mode, list(flat_list)[:(len(flat_list) + 1) // 2], *a, **k)

    patch(ops, "valley_ridge", valley_ridge)


def _answer_altered(patch):
    from topo_descriptors_tpu_torch import pipeline

    original = pipeline._to_host

    def altered(t):
        out = np.array(original(t))
        out[..., out.shape[-2] // 2, out.shape[-1] // 2] += 1.0
        return out

    patch(pipeline, "_to_host", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` in place, restored on exit."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    try:
        FAULTS[name](patch)
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
