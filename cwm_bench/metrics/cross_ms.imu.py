"""Device ms of the conjoined engine's cross blocks in the per-sample
suffix (the program's spans cf.suffix.cross, all of one dispatch
together: four encoder and four decoder blocks in imu400), the median of
the driver's stage_spans dispatches."""


def read(ctx):
    return ctx.spans.get('cross_ms')
