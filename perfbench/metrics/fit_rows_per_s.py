"""fit_rows_per_s: training rows times epochs of every fit in the window,
over the window's wall (host clock; each fit ends in the fetch of its
weights, which waits for the card)."""


def read(ctx):
    c = ctx["counters"]
    return c["rows"] / c["wall_s"]
