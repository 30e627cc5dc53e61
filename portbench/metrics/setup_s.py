"""setup_s: seconds from the process's start to the window's: imports, the
program's host libraries and kernels loaded (built on a checkout's first
run), the corpora written from the seed and the warm-up pass."""


def read(ctx):
    return ctx.setup_s
