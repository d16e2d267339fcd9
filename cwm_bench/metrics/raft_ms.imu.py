"""Device ms of RAFT-24 in an IMU-conditioned dispatch of an unseen scene
(the program's span cf.raft: the encoders, the correlation pyramid and
the iterations over every sample's frame pair), the median of the
driver's stage_spans dispatches."""


def read(ctx):
    return ctx.spans.get('raft_ms')
