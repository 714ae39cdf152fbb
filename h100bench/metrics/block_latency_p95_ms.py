"""block_latency_p95_ms: the 95th percentile (linear interpolation) over
all blocks of the window of the time from a block's due time to its frames
being ready on the device, event-synchronised; it includes the block's copy
from pinned host memory and any wait behind a late block. Host clock."""

import numpy as np


def read(rec: dict):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95) * 1e3)
