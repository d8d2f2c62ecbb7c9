"""MiB the calls of the window held on the device at their peak, beyond the
input pool and the sampled outputs the benchmark keeps."""


def read(ctx: dict):
    return ctx["work_mib"]
