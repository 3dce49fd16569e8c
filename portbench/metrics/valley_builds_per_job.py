"""valley_builds_per_job: the valley/ridge routes' device banks and canvas
stacks made over the window (``ops.valley_ridge.VALLEY_COUNTS``
``builds.bank`` and ``builds.canvas``: cache misses, and every build of a
route that caches none), per job completed. Silent where the program keeps
no such counter.
Moves out_mpix_s; read in basodino_30m.valley_bank."""

import importlib


def counters():
    module = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    found = getattr(module, "VALLEY_COUNTS", {})
    return {k: found[k] for k in ("builds.bank", "builds.canvas") if k in found}


def read(run):
    builds = run.counters.get("valley_builds_per_job")
    return sum(builds.values()) / run.jobs if builds and run.jobs else None
