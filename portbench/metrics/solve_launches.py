"""Device kernels an Adam iteration of the fit: the difference of two traced
fits of 2 and 12 steps (the same set-up, lag history and capture), over 10."""


def read(ctx):
    a, b = (ctx.trace[f"fit{k}"] for k in ctx.shapes["trace_steps"])
    if not b.device:
        return None
    lo, hi = ctx.shapes["trace_steps"]
    return (len(b.kernels()) - len(a.kernels())) / (hi - lo)
