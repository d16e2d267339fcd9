from . import flops, train  # noqa: F401
