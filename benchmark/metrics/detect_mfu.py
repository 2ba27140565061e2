"""The whole detect step's share of the card's int8 peak: the logical
int8 ops of a batch (``costs``: 2 per multiply-add of every conv) times
the window's batches a second, over the data-sheet peak."""


def read(ctx):
    if ctx.peaks is None:
        return None
    ops = sum(o for _, o, _ in ctx.costs)
    rate = ctx.window.batches_in_window / ctx.seconds
    return 100.0 * ops * rate / ctx.peaks["int8_ops"]
