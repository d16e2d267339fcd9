from . import generators, mask_ops  # noqa: F401
