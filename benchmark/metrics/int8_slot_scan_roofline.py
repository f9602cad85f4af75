"""int8_slot_scan_roofline: the int8 slot scan's share of its roofline, in
per cent: the least time the exhaustive int8 scan of each call's own
queries over the index's rows could take on the card
(``benchmark/bounds.py``: operations at the int8 peak or bytes at the HBM
rate, whichever binds), summed over the ``DeviceVectorIndex.search`` calls
of the profiled stretch (each by its share inside it; every call of the
int8 route launches the scan), over the scan kernel's device time in
them."""

from benchmark.bounds import int8_bound_ms

SCAN = "slot_scan_wgmma"
SLOTS, KEEP = 256, 2  # the top-2 mode's slot table (ops/slot_scan.py RESIDENT2_SLOTS)


def read(run):
    calls = run.device_calls
    if calls is None:
        return None
    kernel_ms = sum(dur for name, dur in calls.ops if SCAN in name) / 1e3
    bound_ms = sum(share * int8_bound_ms(rows, run.rows, run.dim, SLOTS, KEEP)[0] for share, rows in calls.shares)
    return 100.0 * bound_ms / kernel_ms if kernel_ms > 0 else None
