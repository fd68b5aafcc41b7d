from mass_tpu_torch.maps.layers import (  # noqa: F401
    ClipMap, FeatureMap, MapSet, OccupancyMap, SemanticMap)
