"""Batch key schema constants.

Same key strings as the external ``nowcasting_dataset.consts`` the reference
imports (reference satflow/data/datamodules.py:6-20, datasets.py:4-16), so configs
and downstream code match the reference's dict schema 1:1.
"""

SATELLITE_DATA = "sat_data"
SATELLITE_X_COORDS = "sat_x_coords"
SATELLITE_Y_COORDS = "sat_y_coords"
SATELLITE_DATETIME_INDEX = "sat_datetime_index"

NWP_DATA = "nwp"
NWP_X_COORDS = "nwp_x_coords"
NWP_Y_COORDS = "nwp_y_coords"

TOPOGRAPHIC_DATA = "topo_data"
TOPOGRAPHIC_X_COORDS = "topo_x_coords"
TOPOGRAPHIC_Y_COORDS = "topo_y_coords"

DATETIME_FEATURE_NAMES = (
    "hour_of_day_sin",
    "hour_of_day_cos",
    "day_of_year_sin",
    "day_of_year_cos",
)

DEFAULT_REQUIRED_KEYS = (
    NWP_DATA,
    NWP_X_COORDS,
    NWP_Y_COORDS,
    SATELLITE_DATA,
    SATELLITE_X_COORDS,
    SATELLITE_Y_COORDS,
    SATELLITE_DATETIME_INDEX,
    TOPOGRAPHIC_DATA,
    TOPOGRAPHIC_X_COORDS,
    TOPOGRAPHIC_Y_COORDS,
) + DATETIME_FEATURE_NAMES

# Data cadence: one frame per 5 minutes (reference core/utils.py:63).
MINUTES_PER_STEP = 5
