"""% of the bf16 peak: 3 x the train forward's operations (2 x
multiply-adds of every convolution, both RepConv branches and both heads)
for the images of the steps completed in the traced stretch, over its
wall time."""


def read(ctx):
    return ctx.mfu(3 * ctx.image_flops(deploy=False))
