"""Device ms per optimizer step outside the forward's layer ranges: the
batch's copy, the loss, the backward, the clip, SGD and EMA."""


def read(ctx):
    fwd = ctx.forward_us()
    return ctx.per_unit_ms(ctx.summary.device_us - fwd) if fwd > 0 else None
