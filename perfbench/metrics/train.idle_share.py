"""% of the traced stretch in which no kernel or copy ran on the card."""


def read(ctx):
    return ctx.idle_share()
