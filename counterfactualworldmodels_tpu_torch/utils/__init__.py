from . import weights  # noqa: F401
