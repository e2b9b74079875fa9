"""Mean host time of `InferenceServer.submit` (the resize into the canvas, in
the caller's thread) over the window's requests, from the benchmark's own
span around the call (ms)."""


def read(records):
    spans = (records or {}).get("ingest_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
