from . import (movability, patch_selector, perturbation,  # noqa: F401
               segmentation)
from .movability import MovabilityPredictor  # noqa: F401
from .patch_selector import IterativePatchSelector  # noqa: F401
