"""family_s.disk: seconds per job in the disk family's driver calls (TPI,
smoothed TPI and STD), from the harness's spans around each call.
Moves out_mpix_s; read in basodino_30m.batch_disk."""

CALLS = ("compute_tpi", "compute_std")


def read(run):
    spans = [c.seconds for c in run.calls if c.call in CALLS]
    return sum(spans) / run.jobs if spans else None
