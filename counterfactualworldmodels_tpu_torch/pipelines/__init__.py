from . import perturbation, segmentation  # noqa: F401
