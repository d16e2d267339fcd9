from . import shards  # noqa: F401
