"""table_builds_per_job: misses of the program's device-table caches over
the window (``TableCache.builds`` of disk_sat, sx_block and sx_sweep's
``TABLES`` and ``ops.sx.DEDUPED``), per job completed.
Moves out_mpix_s; read in basodino_30m.batch_disk."""

import importlib


def counters():
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block, sx_sweep

    sx = importlib.import_module("topo_descriptors_tpu_torch.ops.sx")
    return {"disk_sat": disk_sat.TABLES.builds, "sx_block": sx_block.TABLES.builds,
            "sx_sweep": sx_sweep.TABLES.builds, "sx_dedupe": sx.DEDUPED.builds}


def read(run):
    builds = run.counters.get("table_builds_per_job")
    return sum(builds.values()) / run.jobs if builds and run.jobs else None
