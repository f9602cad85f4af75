"""scan.kernel_ms: device milliseconds per launch of the int8 slot scan
(``csrc/int8_slot_scan.cu``, by its kernel's name in the profile), over
the ``DeviceVectorIndex.search`` calls of the profiled stretch."""

SCAN = "slot_scan_wgmma"


def read(run):
    calls = run.device_calls
    durs = [dur for name, dur in calls.ops if SCAN in name] if calls is not None else []
    return sum(durs) / len(durs) / 1e3 if durs else None
