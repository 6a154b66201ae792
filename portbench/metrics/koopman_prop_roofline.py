"""The propagation's GEMMs (``z A^T`` and ``u B^T``, H steps, every start):
their bound at the horizons' shapes (operations at 67 TFLOP/s or bytes at
3.35 TB/s) over the device time of every kernel launched inside the spans
``brov2.koopman.propagate`` (the GEMMs and the adds), a scoring, in %."""

from portbench import opcounts
from portbench.readers import roofline_percent


def read(ctx):
    occ = ctx.trace["launched"]["brov2.koopman.propagate"]
    per = ctx.shapes["per_horizon"]
    n = ctx.trace["requests"]
    if not ctx.on_card or len(occ) != n * len(per):
        return None
    bound = sum(opcounts.bound_s(v["prop_ops"], v["prop_bytes"]) for v in per.values())
    return roofline_percent(bound, [(name, s, e) for o in occ for name, _, s, e in o], n)
