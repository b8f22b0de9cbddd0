"""Kernel launches the host makes a clip: the profiler's runtime launch
calls over the attribution pass's clips, one of each 1 s bucket. A count,
not a time: the window's profile records the device alone, and cannot tie
a launch to its clip."""

NEEDS = ("stack",)


def read(ctx):
    t = ctx.stack
    if t is None or not t.launches():
        return None
    return t.launches() / ctx.driver.stack_clips
