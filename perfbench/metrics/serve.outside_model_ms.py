"""Device ms per request outside the model's layer ranges: the frames'
copy, the letterbox, NMS and the detections' copy back."""


def read(ctx):
    fwd = ctx.forward_us()
    return ctx.per_unit_ms(ctx.summary.device_us - fwd) if fwd > 0 else None
