"""entry: the host's time to issue one step of the program's `evolve`, read
by the host clock around chunks of steps with no wait on the device, each
chunk short enough that the launch queue does not fill."""


def read(ctx):
    return ctx["issue_s_per_step"] * 1e3
