"""coalescer.queries_per_dispatch: queries the node's coalescer merged per
dispatch over the window, from its own counters (``batched_queries`` and
``dispatches``, counted under its lock). Nothing to read where no query
rode the coalescer."""


def read(run):
    dispatches, queries = run.coalescer or (0, 0)
    return queries / dispatches if dispatches > 0 else None
