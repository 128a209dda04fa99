"""setup_s: seconds from process start to the first timed unit."""


def read(ctx):
    return ctx.run["setup_s"]
