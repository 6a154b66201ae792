"""Device kernels a Koopman fit (no copies or sets), from the traced fits;
nothing off the card."""


def read(ctx):
    tr = ctx.trace["window"]
    return len(tr.kernels()) / ctx.trace["requests"] if ctx.on_card and tr.device else None
