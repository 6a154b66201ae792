"""The device's idle share of a whole solve, in %: the busy time of the two
traced fits of 2 and 12 steps split into a fixed part and a part an
iteration, made up to the solve's steps, over a solve's wall time in the
measured (untraced) window."""


def read(ctx):
    lo, hi = ctx.shapes["trace_steps"]
    a, b = ctx.trace[f"fit{lo}"], ctx.trace[f"fit{hi}"]
    if not ctx.on_card or not b.device:
        return None
    per_step = (b.busy_s() - a.busy_s()) / (hi - lo)
    busy = a.busy_s() - lo * per_step + ctx.shapes["steps"] * per_step
    return 100.0 * (1.0 - busy / ctx.window["wall_per_request_s"])
