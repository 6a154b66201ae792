"""The normal equations' Gram ``G^T G`` and right-hand side ``G^T Z+``
(float64): their bound (operations at 67 TFLOP/s or bytes at 3.35 TB/s)
over the device time of the kernels their two ``aten::mm`` launched inside
the span ``brov2.koopman.normal_eqns``, a traced fit, in %."""

from portbench import opcounts
from portbench.readers import roofline_percent
from portbench.trace import is_copy_or_set


def read(ctx):
    occ = ctx.trace["launched"]["brov2.koopman.normal_eqns"]
    n = ctx.trace["requests"]
    if not ctx.on_card or len(occ) != n:
        return None
    k = [(name, s, e) for o in occ for name, op, s, e in o
         if op == "aten::mm" and not is_copy_or_set(name)]
    s = ctx.shapes
    return roofline_percent(opcounts.bound_s(s["gram_ops"], s["gram_bytes"]), k, n)
