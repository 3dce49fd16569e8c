"""valley_bank_build_s: the host seconds of the valley/ridge bank builds
over the window (``ops.valley_ridge.VALLEY_COUNTS["bank_build_s"]``: the
scipy rotations, the flat fold and the staging of each bank made), per job
completed. Silent where the program keeps no such counter.
Moves out_mpix_s; read in basodino_30m.valley_bank."""

import importlib


def counters():
    module = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    found = getattr(module, "VALLEY_COUNTS", {})
    return {"bank_build_s": found["bank_build_s"]} if "bank_build_s" in found else {}


def read(run):
    seconds = run.counters.get("valley_bank_build_s")
    return seconds["bank_build_s"] / run.jobs if seconds and run.jobs else None
