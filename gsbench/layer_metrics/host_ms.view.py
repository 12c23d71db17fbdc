"""Host milliseconds a frame: the harness's host clock around each
graphed frame's call (its camera copy and the replay's launch, not the
wait for its image) in the measured window, averaged over the frames."""


def read(ctx):
    return ctx["host_ms"]
