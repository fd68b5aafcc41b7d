"""Sorted record streams with chosen run lengths for the port's splat
kernel and its plain version, and a naive float32 loop of the same
update.  No JAX: ``tests/test_torch_gpu.py`` runs on a machine that has
only PyTorch.
"""

import numpy as np

# records per tile of csrc/splat_onehot.cu (kTile); test_torch_gpu.py
# checks the built library's splat_onehot_tile() against it
TILE_RECORDS = 1024
# resident blocks an SM of sm_90 holds at most, whatever their size
MAX_BLOCKS_PER_SM = 32
NUM_VOXELS = 4096
# features of each map of a group of M maps (occupancy first, as the
# agent's compat group; 128 is the kernel's widest map)
FEATURES = {1: (54,), 2: (1, 54), 3: (1, 54, 7), 4: (1, 54, 7, 128)}
INTERPOLATION_WEIGHTS = (0.5, 0.25, 0.75, 0.125)

# run lengths of negative ids (ids -K..-1, which no path makes and the
# splat skips), run lengths of valid voxels, and the count of discard
# records (id V)
STREAMS = {
    "runs_1_31_32_33": ((), (1, 31, 32, 33), 5),
    "shorter_than_tile": ((), (3, 7, 1), 0),
    "straddles_tile": ((), (TILE_RECORDS - 10, 25, 40), 3),
    "longer_than_tile": ((), (2, 2 * TILE_RECORDS + 517, 1, 60), 11),
    "one_voxel": ((), (3 * TILE_RECORDS + 100,), 0),
    "all_invalid": ((), (), 2 * TILE_RECORDS + 9),
    "many_runs": ((), tuple(np.random.RandomState(7).geometric(1 / 19, 400)),
                  TILE_RECORDS + 1),
    "negative_ids": ((3, TILE_RECORDS + 5), (33, 2), 4),
}


def _stream(negative, lengths, discarded, num_voxels, num_maps, rng):
    voxels = np.sort(rng.choice(num_voxels, len(lengths), replace=False))
    ids = np.concatenate([
        np.repeat(np.arange(-len(negative), 0), negative),
        np.repeat(voxels, lengths),
        np.full(discarded, num_voxels)]).astype(np.int32)
    weights = rng.uniform(1e-9, 1.0, ids.shape[0]).astype(np.float32)
    feats = FEATURES[num_maps]
    classes = np.stack([rng.randint(-1, f + 1, ids.shape[0])
                        for f in feats]).astype(np.int32)
    datas = [rng.rand(num_voxels, f).astype(np.float32) for f in feats]
    return ids, weights, classes, datas


def stream(name: str, num_maps: int, seed: int = 0):
    """One stream as numpy: sorted int32 ids ``[R]``, float32 weights
    ``[R]``, int32 classes ``[M, R]`` (a few outside each map's range,
    which the splat drops) and M maps ``[V, F_m]`` of random values."""
    return _stream(*STREAMS[name], NUM_VOXELS, num_maps,
                   np.random.RandomState(seed))


def many_tile_stream(num_tiles: int, num_maps: int, seed: int = 0):
    """:func:`stream`'s arrays for a stream of ``num_tiles`` tiles and a
    part of one more: runs of about 40 records with every 4,000th run
    longer than two tiles, so runs cross tile ends all along, then a few
    discard records, on a grid of one voxel per ten records."""
    rng = np.random.RandomState(seed)
    total = num_tiles * TILE_RECORDS + 517
    lengths = rng.geometric(1 / 40, total // 20)
    lengths[::4000] = 2 * TILE_RECORDS + 300
    lengths = lengths[:np.searchsorted(np.cumsum(lengths), total - 7) + 1]
    lengths[-1] -= lengths.sum() - (total - 7)
    return _stream((), lengths, 7, total // 10, num_maps, rng)


def naive_splat(datas, ids, weights, classes, iws):
    """The update voxel by voxel in float32, each sum in record order,
    no fused multiply-add: what the kernel computes."""
    f32 = np.float32
    outs = [d.copy() for d in datas]
    bounds = np.flatnonzero(np.diff(ids)) + 1
    for run in np.split(np.arange(ids.shape[0]), bounds):
        if run.size == 0 or not 0 <= ids[run[0]] < datas[0].shape[0]:
            continue
        w_sum, s2_sum = f32(0), f32(0)
        t = [np.zeros(d.shape[1], f32) for d in datas]
        for r in run:
            w2 = f32(weights[r] * weights[r])
            w_sum = f32(w_sum + weights[r])
            s2_sum = f32(s2_sum + w2)
            for m, d in enumerate(datas):
                if 0 <= classes[m, r] < d.shape[1]:
                    t[m][classes[m, r]] = f32(t[m][classes[m, r]] + w2)
        safe = max(w_sum, f32(1e-30))
        for m, out in enumerate(outs):
            iw = f32(iws[m])
            mult = (f32(1) - f32(f32(iw * s2_sum) / safe) if w_sum > 0
                    else f32(1))
            scale = f32(iw / safe)
            v = ids[run[0]]
            out[v] = (out[v] * mult).astype(f32) + (scale * t[m]).astype(f32)
    return outs
