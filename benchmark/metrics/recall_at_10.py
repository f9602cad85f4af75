"""recall_at_10: the share of the plain reference's exact top-10 that the
first ten hits held, over the compared queries of the window."""


def read(run):
    return run.numbers["recall_at_10"] if run.numbers.get("compared") else None
