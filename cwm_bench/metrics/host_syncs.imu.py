"""The host's waits for the device in one IMU-conditioned dispatch: the
sum of the program's host_sync.* counters, each the median of the driver's
stage_spans dispatches; nothing where the program counts none."""


def read(ctx):
    waits = [v for k, v in ctx.counters.items() if k.startswith('host_sync.')]
    return sum(waits) if waits else None
