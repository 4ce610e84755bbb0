"""setup_s: seconds from the process's start to the window's (imports,
the CUDA context, the kernels' build or load, inputs, the program's
set-up and warm-up), host clock."""


def read(ctx):
    return ctx["setup_s"]
