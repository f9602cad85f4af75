"""device.launches_per_dispatch: kernels, copies and fills the card ran
per ``DeviceVectorIndex.search`` call, over the calls of the profiled
stretch."""


def read(run):
    calls = run.device_calls
    if calls is None or not calls.ops or calls.count <= 0:
        return None
    return len(calls.ops) / calls.count
