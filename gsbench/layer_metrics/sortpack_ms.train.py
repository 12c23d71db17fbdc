"""Device milliseconds a train step of the sort-pack: the kernels launched
inside the program's `render.pack` range, or by the backward of an autograd
node made there (the gather's index-add), in eager steps of the same state
under the profiler (a graph's replay carries no host ranges)."""


def read(ctx):
    return 1e3 * ctx["sortpack_s"]
