"""searcher.host_ms: host milliseconds a ``VectorSearcher.search`` call
spends outside ``DeviceVectorIndex.search`` (the request's mask and key
mapping, the hits), over every call of the traced window, from the
benchmark's spans around the two calls."""


def read(run):
    calls = [s for s in run.spans if s.name == "searcher.search"]
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns - s.child_ns for s in calls) / len(calls) / 1e6
