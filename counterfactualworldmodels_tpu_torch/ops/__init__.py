from . import (coords, flash_attention, flow_viz, layer_norm,  # noqa: F401
               linear, misc, normalization, patches, pos_embed, resize)
