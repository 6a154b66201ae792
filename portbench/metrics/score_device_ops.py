"""Device operations (kernels, copies, sets) a scoring, from the trace: the
wrapper's launches and read-backs around the window kernels."""


def read(ctx):
    tr = ctx.trace["window"]
    return len(tr.device) / ctx.trace["requests"] if tr.device else None
