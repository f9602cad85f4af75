"""qps: queries answered in the window over the window's seconds (the
window runs from its opening to the reply of its last request)."""


def read(run):
    w = run.window
    return (w.attempted - w.failed) / w.seconds if w.seconds > 0 else None
