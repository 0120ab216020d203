"""% of the bf16 peak: the deployed model's operations (2 x multiply-adds
of every convolution at the configuration's size, counted from its
shapes) for the images completed in the traced stretch, over its wall
time."""


def read(ctx):
    return ctx.mfu(ctx.image_flops(deploy=True))
