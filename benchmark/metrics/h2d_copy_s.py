"""Seconds a call of host-to-device copies on the card (``Memcpy HtoD``)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return t.op_us(lambda name: name.startswith("Memcpy HtoD")) / 1e6 / t.calls
