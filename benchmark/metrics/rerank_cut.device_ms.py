"""rerank_cut.device_ms: device milliseconds per ``DeviceVectorIndex.search``
call of every kernel, copy and fill other than the int8 slot scan (the
query's quantisation, the slot top-c, the exact rerank's gather and
product, the dedup, the cut, the uploads and the fetch), over the calls of
the profiled stretch."""

SCAN = "slot_scan_wgmma"


def read(run):
    calls = run.device_calls
    if calls is None or not calls.ops or calls.count <= 0:
        return None
    return sum(dur for name, dur in calls.ops if SCAN not in name) / calls.count / 1e3
