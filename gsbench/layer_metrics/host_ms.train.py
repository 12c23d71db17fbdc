"""Host milliseconds a train step: the harness's host clock around each
graphed step's call (its camera and target copies and the replay's launch)
in the measured window, averaged over the steps."""


def read(ctx):
    return ctx["host_ms"]
