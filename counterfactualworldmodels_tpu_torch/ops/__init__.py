from . import (coords, flash_attention, flow_viz, normalization,  # noqa: F401
               patches, pos_embed)
