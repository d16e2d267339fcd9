from . import (coords, flash_attention, flow_viz, misc,  # noqa: F401
               normalization, patches, pos_embed, resize)
