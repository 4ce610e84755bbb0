"""setup_s: seconds from the process's start to the window's (imports,
the CUDA context, the kernels' build or load, inputs, the program's
set-up and warm-up), less the seconds in which a kind's set-up made or
read the benchmark's own input files (the chain's cohort,
``Cell.setup_apart_s``), host clock."""


def read(ctx):
    return ctx["setup_s"]
