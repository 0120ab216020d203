"""Device ms per request inside the model's layer ranges (the fused
forward, decode in the head included)."""


def read(ctx):
    us = ctx.forward_us()
    return ctx.per_unit_ms(us) if us > 0 else None
