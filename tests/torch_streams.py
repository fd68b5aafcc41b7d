"""Sorted record streams with chosen run lengths for the port's splat
kernel and its plain version (one frame, and T frames with chosen
sub-runs), and naive float32 loops of the same updates.  No JAX:
``tests/test_torch_gpu.py`` runs on a machine that has only PyTorch.
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


T = TILE_RECORDS


def _random_runs(num_frames: int, num_runs: int):
    """Runs of about 19 records, each record of a random frame."""
    rng = np.random.RandomState(8)
    return tuple(
        tuple(zip(*np.unique(rng.randint(0, num_frames, n),
                             return_counts=True)))
        for n in rng.geometric(1 / 19, num_runs))


# T-frame streams: (frames, runs of negative ids, runs of valid voxels,
# the discard run); a run is its sub-runs as (frame, records) pairs in
# frame order
FRAME_STREAMS = {
    "subruns_1_31_32_33": (4, (), (((0, 1), (1, 31), (2, 32), (3, 33)),
                                   ((0, 33), (2, 32)), ((1, 31), (3, 1)),
                                   ((3, 32),)), ((0, 2), (2, 3))),
    # the second run's frame 1 starts at record T exactly
    "frame_change_at_tile_end": (2, (), (((0, T - 5),), ((0, 5), (1, 20)),
                                         ((1, 3),)), ((1, 4),)),
    # frame 1's sub-run covers records T - 30 .. T + 29
    "subrun_straddles_tile": (3, (), (((0, T - 40),),
                                      ((0, 10), (1, 60), (2, 5)),
                                      ((2, 7),)), ((0, 1),)),
    "run_over_two_tiles_three_frames": (3, (), (
        ((1, 3),), ((0, 700), (1, 1200), (2, 900)), ((0, 2), (2, 2))),
        ((0, 5),)),
    "one_frame": (1, (), (((0, 1),), ((0, 31),), ((0, 32),), ((0, 33),),
                          ((0, T + 5),)), ((0, 9),)),
    "frame_of_discards_only": (3, (), (((0, 4), (2, 6)), ((0, 40),),
                                       ((2, 1),)),
                               ((0, 3), (1, 50), (2, 2))),
    "skips_frame_1": (3, (), (((0, 5), (2, 7)), ((1, 9),),
                              ((0, 3), (1, 2), (2, 4)),
                              ((0, 12), (2, 33))), ((1, 3),)),
    "negative_ids": (2, (((0, 3),), ((0, 2), (1, T + 5))),
                     (((0, 33), (1, 2)), ((1, 4),)), ((0, 1), (1, 3))),
    "many_runs": (8, (), _random_runs(8, 400), ((3, T + 1),)),
}


def _frame_records(runs):
    """(frames, records per run) of runs given as sub-run pairs."""
    frames = [np.repeat([f for f, _ in run], [c for _, c in run])
              for run in runs]
    return frames, [len(f) for f in frames]


def frame_stream(name: str, num_features: int = 54, seed: int = 0):
    """One T-frame stream as numpy: sorted int32 ids ``[R]``, float32
    weights ``[R]``, int32 classes ``[R]`` (a few outside ``[0, F)``),
    int32 frames ``[R]`` (nondecreasing inside each run) and a map
    ``[V, F]`` of random values."""
    rng = np.random.RandomState(seed)
    _, negative, runs, discarded = FRAME_STREAMS[name]
    voxels = np.sort(rng.choice(NUM_VOXELS, len(runs), replace=False))
    neg_frames, neg_lengths = _frame_records(negative)
    frames, lengths = _frame_records(runs)
    disc_frames, [num_discarded] = _frame_records([discarded])
    ids = np.concatenate([
        np.repeat(np.arange(-len(negative), 0), neg_lengths),
        np.repeat(voxels, lengths),
        np.full(num_discarded, NUM_VOXELS)]).astype(np.int32)
    frames = np.concatenate(neg_frames + frames + disc_frames).astype(
        np.int32)
    weights = rng.uniform(1e-9, 1.0, ids.shape[0]).astype(np.float32)
    classes = rng.randint(-1, num_features + 1, ids.shape[0]).astype(
        np.int32)
    data = rng.rand(NUM_VOXELS, num_features).astype(np.float32)
    return ids, weights, classes, frames, data


def many_tile_frame_stream(num_tiles: int, num_frames: int = 8,
                           seed: int = 0):
    """:func:`many_tile_stream`'s one-map records with random frames in
    ``[0, num_frames)``, sorted inside each run, so sub-runs cross tile
    ends all along: ``(ids, weights, classes, frames, data)``."""
    ids, weights, classes, [data] = many_tile_stream(num_tiles, 1, seed)
    frames = np.random.RandomState(seed).randint(
        0, num_frames, ids.shape[0]).astype(np.int32)
    order = np.lexsort((frames, ids))
    return ids, weights, classes[0], frames[order], data


def naive_frames_splat(data, ids, weights, classes, frames, iw):
    """T frames in frame order, each a :func:`naive_splat` of that
    frame's records: what T single-map updates in a row compute."""
    out = data
    for t in np.unique(frames):
        sel = frames == t
        [out] = naive_splat([out], ids[sel], weights[sel],
                            classes[None, sel], [iw])
    return out


# records a warp's window holds in csrc/splat_dense.cu (kWindow), and
# records one load of a window's tail run spans (kAhead * 32) past the 32
# records after the window, which the warp reads with its window;
# test_torch_gpu.py checks the built library's splat_dense_config()
# against both
DENSE_WINDOW = 32
DENSE_TAIL_LOAD = 128
# the dense kernel's widths: one channel, a slice's ragged edge, the
# backbone's 256 and the kernel's widest
DENSE_FEATURES = (1, 7, 256, 1024)

# dense-record streams, as sorted: runs of negative ids, runs of valid
# voxels, and the count of discard records (id V).  In a sorted stream an
# id outside [0, V) sorts before (negative) or after (V and up) every
# voxel, so an invalid run lies between runs where two of them meet or
# where one meets a voxel's run, as in "invalid_runs_around_voxels".
DENSE_STREAMS = {
    "single_record_runs": ((), (1,) * 70, 3),
    "runs_1_31_32_33": ((), (1, 31, 32, 33, 2), 5),
    # the second run covers records 20-59, the fifth 92-155
    "straddles_window": ((), (20, 40, 3, 29, 64, 7), 4),
    "longer_than_tail_load": ((), (2, 3 * DENSE_TAIL_LOAD + 201, 1, 60), 9),
    # tails that end on the last record the warp reads with its window
    # (record 63) and on the last of the first tail load past it (255)
    "tails_end_at_load_edges": ((), (1, 63, 1, 2 * DENSE_WINDOW
                                             + DENSE_TAIL_LOAD - 1, 5), 3),
    # about 15,000 records in 462 windows: at F = 1024 (8 warps a window)
    # more warps than a card holds at once
    "many_runs": ((), tuple(np.random.RandomState(9).geometric(1 / 6, 2500)),
                  DENSE_WINDOW + 3),
    "all_discard": ((), (), 3 * DENSE_WINDOW + 5),
    # ids -2 (records 0-4) and -1 (5-44), voxels from 45, discards after
    "invalid_runs_around_voxels": ((5, 40), (3, 33, 1, 30), 50),
}


def dense_stream(name: str, num_features: int, seed: int = 0):
    """One dense stream as the mapping makes it, corner-major: int32 ids
    ``[8N]`` and float32 weights ``[8N]`` (record ``r`` carries pixel
    ``r % N``), float32 features ``[N, F]`` and a map ``[V, F]`` of random
    values.  The ids are the stream's sorted ids at random positions, so
    a stable sort gives back its runs; discard records pad it to 8N."""
    rng = np.random.RandomState(seed)
    negative, lengths, discarded = DENSE_STREAMS[name]
    voxels = np.sort(rng.choice(NUM_VOXELS, len(lengths), replace=False))
    total = sum(negative) + sum(lengths) + discarded
    sorted_ids = np.concatenate([
        np.repeat(np.arange(-len(negative), 0), negative),
        np.repeat(voxels, lengths),
        np.full(discarded + (-total) % 8, NUM_VOXELS)]).astype(np.int32)
    ids = np.empty_like(sorted_ids)
    ids[rng.permutation(sorted_ids.shape[0])] = sorted_ids
    weights = rng.uniform(1e-9, 1.0, ids.shape[0]).astype(np.float32)
    feats = rng.randn(ids.shape[0] // 8, num_features).astype(np.float32)
    data = rng.rand(NUM_VOXELS, num_features).astype(np.float32)
    return ids, weights, feats, data
