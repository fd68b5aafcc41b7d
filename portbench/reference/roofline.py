"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W limit) and the least bytes a map update, one-hot or dense, must
move.

The fp32 rate is the one outside the tensor cores: the configurations
keep TF32 off, so it is the ceiling of their arithmetic.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def map_update_bytes(touched_voxels: int, channels: int, pixels: int,
                     value_bytes: int = 4) -> int:
    """Each touched voxel row read and written once, each pixel's depth
    and class read once."""
    return 2 * touched_voxels * channels * value_bytes + pixels * 8


def dense_update_bytes(touched_voxels: int, channels: int, records: int,
                       pixels: int, value_bytes: int = 4) -> int:
    """Each touched voxel row read and written once, each record's id,
    weight and pixel (int32, float32, int32) read once, each pixel's
    feature row read once."""
    return (2 * touched_voxels * channels * value_bytes + records * 12
            + pixels * channels * value_bytes)
