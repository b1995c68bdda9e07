"""step: device time a step of every device operation that is not one of
the program's own CUDA kernels (the convection's gathers, products and
sums, the drag and lift products, copies), from the profiler's device-side
events."""

from portbench.devtrace import is_kernel


def read(ctx):
    prof = ctx["profile"]
    if not prof["by_name"]:
        return None
    other = sum(t for name, t in prof["by_name"].items()
                if not any(is_kernel(name, k) for k in ctx["port_kernels"]))
    return other / prof["steps"] * 1e3
