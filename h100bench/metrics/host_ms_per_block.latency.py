"""host_ms_per_block.latency: the mean of the harness's host spans around
each call of the stream's step ("issue": StreamingNorthStar.process, no
synchronise inside), in ms. Blocks inside a traced stretch are left out.
Host clock."""


def read(rec: dict):
    spans = rec["spans"].of("issue", traced=False)
    if not spans or rec["traffic"]["loop"] != "open":
        return None
    return sum(spans) / len(spans) * 1e3
