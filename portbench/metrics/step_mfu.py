"""step: the whole step's share of the chip's peak.  The least time of one
step (every flow's unpadded operators and vectors, portbench/counts) at the
chip's peaks over the wall time of a step, timed unprofiled over the run's
window of whole solves."""


def read(ctx):
    least = ctx["least_seconds"](ctx["step_counts"])
    return least and 100.0 * least / ctx["wall_s_per_step"]
