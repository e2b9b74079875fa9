"""The batcher's mean share of filled slots over the window's batches, from the
server's own counters (`stats()["mean_batch_occupancy"]`) (%)."""


def read(records):
    stats = (records or {}).get("stats") or {}
    if not stats.get("batches"):
        return None
    return 100.0 * stats["mean_batch_occupancy"]
