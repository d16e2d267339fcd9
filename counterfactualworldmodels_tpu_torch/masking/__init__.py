from . import mask_ops  # noqa: F401
