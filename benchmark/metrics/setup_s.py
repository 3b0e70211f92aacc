"""setup_s: seconds from the process's start to the end of the first call
(the imports, the inputs made on the card, the kernels built or loaded, every
shape of the cell warmed by that call)."""


def read(ctx):
    return ctx.setup_s
