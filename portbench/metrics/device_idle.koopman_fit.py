"""The device's idle share of the traced Koopman fits, in %; nothing off the
card."""

from portbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx.trace["window"]) if ctx.on_card else None
