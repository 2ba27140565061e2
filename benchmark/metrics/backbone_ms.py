"""CUDA-event ms of the integer backbone on one pool batch, replayed from
a CUDA graph of its own (no launch gaps), on a second packed copy of the
served model."""


def backbone(ctx):
    def measure():
        fn = ctx.make_backbone()
        return ctx.graph_ms(fn, ctx.pool[0])
    return ctx.cached("backbone", measure)


def read(ctx):
    return backbone(ctx)[0]
