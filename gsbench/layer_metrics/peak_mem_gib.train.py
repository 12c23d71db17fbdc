"""The peak of the memory the program's allocator held in the measured
window (`torch.cuda.max_memory_allocated` after a reset at its start), GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
