"""Device ms per optimizer step inside the train forward's layer ranges
(both branches of a dual model)."""


def read(ctx):
    us = ctx.forward_us()
    return ctx.per_unit_ms(us) if us > 0 else None
