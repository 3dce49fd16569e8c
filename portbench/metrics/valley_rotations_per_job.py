"""valley_rotations_per_job: the quadrant-angle canvases the streamed
valley/ridge route rotated over the window
(``ops.valley_ridge.VALLEY_COUNTS["rotations.canvas"]``: into a cached
stack on a cache miss, or inline in every call whose stack exceeds the
cache's budget), per job completed. Silent where the program keeps no such
counter.
Moves out_mpix_s; read in basodino_30m.valley_streamed."""

import importlib

KEY = "rotations.canvas"


def counters():
    module = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    found = getattr(module, "VALLEY_COUNTS", {})
    return {KEY: found[KEY]} if KEY in found else {}


def read(run):
    counted = run.counters.get("valley_rotations_per_job")
    return counted[KEY] / run.jobs if counted and run.jobs else None
