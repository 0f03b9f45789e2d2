"""Set-up: process start to the first timed call (loading, building,
warming)."""


def read(ctx):
    return ctx["setup_s"]
