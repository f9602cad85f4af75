"""setup_s: seconds from the process's start to the window's first
request: imports, the corpus and its index, the query pool, the client
threads' warm-up and, on a checkout's first run, the kernels' build."""


def read(run):
    return run.setup_s
