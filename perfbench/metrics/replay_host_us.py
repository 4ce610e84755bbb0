"""replay_host_us: the mean host time of one call of the captured
training step (``train.CapturedStep.__call__``: the graph's replay and
its count), us, over the replays taken while no profiler recorded (the
tracer's ``v2p.train.replays`` counter and its host nanoseconds). Where
the card's launch queue is full the call waits for room, so at a
card-bound step it reads near the device's step. Nothing where the
program keeps no such counter or took no replay."""
COUNTER = "v2p.train.replays"


def read(ctx):
    try:
        from vcf2prot_tpu_torch.utils.timers import TRACER
    except ImportError:  # a program without its tracer
        return None
    n, ns = TRACER.counts(COUNTER, False)
    return ns / n * 1e-3 if n else None
