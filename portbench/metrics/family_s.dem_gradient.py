"""family_s.dem_gradient: seconds per job in the smoothed-DEM and gradient
driver calls, from the harness's spans around each call.
Moves out_mpix_s; read in basodino_30m.batch_disk."""

CALLS = ("compute_dem", "compute_gradient")


def read(run):
    spans = [c.seconds for c in run.calls if c.call in CALLS]
    return sum(spans) / run.jobs if spans else None
