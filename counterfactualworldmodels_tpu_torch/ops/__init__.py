from . import flash_attention, normalization, patches, pos_embed  # noqa: F401
