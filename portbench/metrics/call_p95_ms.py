"""call_p95_ms: the 95th percentile of the driver calls' wall time (call to
host arrays in hand), over every driver call of the window."""

import numpy as np


def read(run):
    walls = [c.seconds for c in run.calls if c.driver]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
