"""resolution_s: the host seconds of the grid's metric resolution over the
window (``grid.RESOLUTION_COUNTS["host_s"]``: a geographic grid's UTM
reprojection and ``np.gradient``, once per driver call), per job completed.
Silent where the program keeps no such counter.
Moves out_mpix_s; read in basodino_30m.batch_disk and basodino_30m.valley_bank."""

import importlib


def counters():
    module = importlib.import_module("topo_descriptors_tpu_torch.grid")
    found = getattr(module, "RESOLUTION_COUNTS", {})
    return {"host_s": found["host_s"]} if "host_s" in found else {}


def read(run):
    seconds = run.counters.get("resolution_s")
    return seconds["host_s"] / run.jobs if seconds and run.jobs else None
