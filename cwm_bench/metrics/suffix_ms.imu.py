"""Device ms of the conjoined engine's per-sample suffix (the program's
span cf.suffix: the encoder suffix with the per-sample context stream, and
the exact decoder suffix) in a dispatch of an unseen scene, the median of
the driver's stage_spans dispatches."""


def read(ctx):
    return ctx.spans.get('suffix_ms')
