from .subtile import subtile_band_bits
from .tile_contact import (band_emit, band_row_counts, band_row_counts_triton,
                           contact_mask)

__all__ = ["band_emit", "band_row_counts", "band_row_counts_triton",
           "contact_mask", "subtile_band_bits"]
