"""kernel: the share of its roofline that the program's `banded_tiles_kernel`
reaches.  The least time of the CG step's 18 banded products (the
operators' nonzeros and the products' vectors, portbench/counts) at the
chip's peaks over the device time a step of the kernel's instances in the
profiled window."""

from portbench.devtrace import is_kernel

KERNEL = "banded_tiles_kernel"


def read(ctx):
    prof = ctx["profile"]
    t = sum(v for name, v in prof["by_name"].items() if is_kernel(name, KERNEL))
    least = ctx["least_seconds"](ctx["kernel_counts"])
    if t <= 0 or not least:
        return None
    return 100.0 * least / (t / prof["steps"])
