"""trainer_setup_s: the seconds of the program's trainer set-up in the
run's set-up (host clock): ``train._trainer``'s uploads, head, epoch
buffers and captured step (its warm-up steps and the capture), the part of
a user's fit that the window's fits do not repeat."""


def read(ctx):
    return ctx["counters"].get("trainer_setup_s")
