"""Images whose per-frame detections reached the host within the window,
over the window's length."""


def read(ctx):
    w = ctx.window
    return w.batches_in_window * w.batch / ctx.seconds
