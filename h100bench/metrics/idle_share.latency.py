"""idle_share.latency: the device's idle share inside the blocks' service
spans only (from the end of the pacing wait to the frames being ready), so
the real-time pacing between blocks is not counted, in %. From the
torch.profiler trace."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["service_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["service_busy_s"] / tr["service_s"])
