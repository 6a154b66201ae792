"""The device's idle share of the traced scorings, in %."""

from portbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx.trace["window"])
