from . import movability, perturbation, segmentation  # noqa: F401
from .movability import MovabilityPredictor  # noqa: F401
