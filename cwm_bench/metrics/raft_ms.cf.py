"""ms of the raft stage of a counterfactual dispatch, called alone at the
cell's shapes (the driver's stage_spans)."""


def read(ctx):
    return ctx.spans.get('raft_ms')
