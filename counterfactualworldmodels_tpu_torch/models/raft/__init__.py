from . import corr, layers, raft  # noqa: F401
