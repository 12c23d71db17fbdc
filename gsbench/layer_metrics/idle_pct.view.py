"""The device's idle share of the traced frames, each awaited before the
next: one less the union of its operations' intervals over the window,
percent."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
