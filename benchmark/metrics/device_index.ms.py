"""device_index.ms: host milliseconds per ``DeviceVectorIndex.search``
call, upload to fetch, over every call of the traced window, from the
benchmark's span around the call."""


def read(run):
    calls = [s for s in run.spans if s.name == "device_index.search"]
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) / len(calls) / 1e6
