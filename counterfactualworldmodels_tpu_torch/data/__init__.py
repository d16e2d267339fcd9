from . import shards, utils  # noqa: F401
