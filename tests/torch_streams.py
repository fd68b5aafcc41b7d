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


# ----------------------------------------------------------------------
# greedy NMS (ops/detection.nms and csrc/nms.cu): chosen box streams
# ----------------------------------------------------------------------

NMS_MAX_BOXES = 1024    # csrc/nms.cu: kMaxBoxes


def _random_boxes(rng, n: int, size: float = 224.0, scale: float = 60.0):
    xy = rng.uniform(0, size - 4, (n, 2))
    wh = rng.uniform(1.0, scale, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1)


def _nms_random(rng):
    return _random_boxes(rng, 200), rng.rand(200), 0.5, 50


def _nms_rpn_level(rng):
    # one RPN level: 500 boxes after the per-level top-k, 256 outputs
    return _random_boxes(rng, 500, scale=120.0), rng.randn(500), 0.7, 256


def _nms_equal_scores(rng):
    # every score equal: the lowest live index wins each pick
    return _random_boxes(rng, 300), np.ones(300), 0.5, 100


def _nms_signed_zeros(rng):
    # +0 and -0 compare equal, as in the float compare of an argmax
    scores = np.where(rng.rand(64) < 0.5, 0.0, -0.0)
    scores[::7] = -1.0
    return _random_boxes(rng, 64), scores, 0.5, 64


def _nms_zero_area(rng):
    # live zero-area boxes with the best scores: IoU 0 with themselves,
    # so each is picked again until the outputs run out
    boxes = _random_boxes(rng, 40)
    boxes[[3, 11], 2] = boxes[[3, 11], 0]
    boxes[17, 3] = boxes[17, 1]
    scores = rng.rand(40)
    scores[[3, 11, 17]] = [5.0, 4.0, 3.0]
    return boxes, scores, 0.5, 40


def _nms_zero_area_after(rng):
    # a zero-area box below the others: it repeats once they are gone
    boxes = _random_boxes(rng, 30)
    boxes[5, 2] = boxes[5, 0]
    scores = rng.rand(30)
    scores[5] = -10.0
    return boxes, scores, 0.3, 30


def _nms_all_dead(rng):
    return _random_boxes(rng, 50), np.full(50, -np.inf), 0.5, 20


def _nms_partly_dead(rng):
    scores = rng.randn(128)
    scores[rng.rand(128) < 0.6] = -np.inf
    return _random_boxes(rng, 128), scores, 0.5, 100


def _nms_class_offsets(rng):
    # the detector's class-aware NMS: 512 candidates offset by class into
    # islands of side image + 2, scores in [0, 1) and -inf where gated
    classes = rng.randint(0, 54, 512)
    boxes = _random_boxes(rng, 512) + (classes * 226.0)[:, None]
    scores = rng.rand(512)
    scores[scores < 0.05] = -np.inf
    return boxes, scores, 0.5, 64


def _nms_duplicates(rng):
    # exact duplicates (IoU exactly 1) and nested boxes
    base = _random_boxes(rng, 20)
    boxes = np.concatenate([base, base, base * 0.5 + 10.0])
    return boxes, rng.rand(60), 0.5, 60


def _nms_widest(rng):
    return (_random_boxes(rng, NMS_MAX_BOXES, scale=30.0),
            rng.rand(NMS_MAX_BOXES), 0.4, 300)


def _integer_boxes(rng, n: int, size: int = 224, scale: int = 60):
    # integer corners: every area and intersection is exact in float32,
    # so an IoU of exactly 1 or exactly the threshold is the same number
    # in every framework's operation order
    xy = rng.randint(0, size - 4, (n, 2))
    wh = rng.randint(1, scale, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1)


def _nms_single_box(rng):
    return _integer_boxes(rng, 1), rng.rand(1), 0.5, 3


def _nms_word_boundaries(rng):
    # scores fall with the index, so sorted position = index; copies of
    # boxes in the word before sit just past 32, 64 and 96, and chains
    # of suppression cross each boundary (a victim of a suppressed box
    # survives)
    boxes = _integer_boxes(rng, 97, scale=40)
    for src, dst in ((31, 32), (30, 33), (0, 64), (63, 64), (62, 65),
                     (95, 96), (33, 96), (1, 95), (29, 63)):
        boxes[dst] = boxes[src] + np.array([1, 0, 1, 1])
    boxes[34] = boxes[32] + np.array([0, 2, 0, 2])     # its killer dies
    return boxes, np.linspace(1.0, 0.0, 97), 0.5, 97


def _nms_cap_above_live(rng):
    # ten islands of six overlapping boxes: ten survive, the cap is 50
    xy = rng.randint(0, 180, (10, 2)) + (np.arange(10) * 210)[:, None]
    base = np.concatenate([xy, xy + rng.randint(12, 20, (10, 2))], 1)
    jitter = rng.randint(0, 2, (10, 6, 4))
    boxes = (base[:, None, :] + jitter).reshape(60, 4)
    return boxes, rng.rand(60), 0.5, 50


def _nms_positive_inf_scores(rng):
    # +inf scores tie: the lowest index among them is picked first
    boxes = _integer_boxes(rng, 80)
    boxes[[21, 50]] = boxes[3]
    scores = rng.randn(80)
    scores[[7, 3, 50, 21, 66]] = np.inf
    scores[[5, 12]] = -np.inf
    return boxes, scores, 0.5, 40


def _nms_threshold_one(rng):
    # exact duplicates (IoU exactly 1) suppress at threshold 1.0; no
    # other pair reaches it
    base = _integer_boxes(rng, 30)
    boxes = np.concatenate([base, base, base[::2]])
    return boxes, rng.rand(boxes.shape[0]), 1.0, boxes.shape[0]


def _nms_threshold_zero(rng):
    # IoU >= 0 always: the first pick, a zero-area box, suppresses all,
    # itself included
    boxes = _integer_boxes(rng, 50)
    boxes[9, 2] = boxes[9, 0]
    scores = rng.rand(50)
    scores[9] = 2.0
    return boxes, scores, 0.0, 20


def _nms_zero_area_mid_word(rng):
    # a zero-area box at sorted position 40 of 100: the boxes before it
    # are taken in order, then it repeats to the cap
    boxes = _integer_boxes(rng, 100)
    scores = rng.rand(100)
    z = np.argsort(-scores, kind="stable")[40]
    boxes[z, 3] = boxes[z, 1]
    return boxes, scores, 0.5, 100


def _iou32(a, b):
    # box_iou's float32 operation order for one pair
    f = np.float32
    area = [f(max(f(x[2] - x[0]), f(0))) * f(max(f(x[3] - x[1]), f(0)))
            for x in (a, b)]
    w = max(f(min(a[2], b[2]) - max(a[0], b[0])), f(0))
    h = max(f(min(a[3], b[3]) - max(a[1], b[1])), f(0))
    inter = f(w * h)
    return f(inter / max(f(f(area[0] + area[1]) - inter), f(1e-9)))


def _nms_threshold_ulps(rng):
    # pairs whose float32 IoU is the threshold itself, the float below it
    # and the float above: each larger box is picked, and its partner is
    # suppressed exactly when the IoU reaches 0.7 in float32
    t = np.float32(0.7)
    targets = [np.nextafter(t, np.float32(0)), t,
               np.nextafter(t, np.float32(1))]
    boxes, scores = [], []
    for island in range(24):
        target = targets[island % 3]
        while True:
            x0, y0 = rng.uniform(0, 150, 2).astype(np.float32) + 200 * island
            big = np.array([x0, y0, x0 + rng.uniform(20, 60),
                            y0 + rng.uniform(20, 60)], np.float32)
            small = big.copy()
            small[2] = x0 + (big[2] - x0) * t
            for _ in range(64):          # walk the edge to the target IoU
                got = _iou32(big, small)
                if got == target:
                    break
                small[2] = np.nextafter(small[2], np.float32(
                    np.inf if got < target else -np.inf))
            if _iou32(big, small) == target:
                break
        boxes += [big, small]
        scores += [1.0 - island / 100, 0.5 - island / 100]
    return np.array(boxes), np.array(scores), float(t), 48


NMS_STREAMS = {
    "random": _nms_random,
    "rpn_level": _nms_rpn_level,
    "equal_scores": _nms_equal_scores,
    "signed_zeros": _nms_signed_zeros,
    "zero_area": _nms_zero_area,
    "zero_area_after": _nms_zero_area_after,
    "all_dead": _nms_all_dead,
    "partly_dead": _nms_partly_dead,
    "class_offsets": _nms_class_offsets,
    "duplicates": _nms_duplicates,
    "widest": _nms_widest,
    "single_box": _nms_single_box,
    "word_boundaries": _nms_word_boundaries,
    "cap_above_live": _nms_cap_above_live,
    "positive_inf_scores": _nms_positive_inf_scores,
    "threshold_one": _nms_threshold_one,
    "threshold_zero": _nms_threshold_zero,
    "zero_area_mid_word": _nms_zero_area_mid_word,
    "threshold_ulps": _nms_threshold_ulps,
}


def nms_stream(name: str, seed: int = 0):
    """``(boxes [N, 4], scores [N] float32, iou_threshold, max_outputs)``
    of a chosen stream."""
    boxes, scores, threshold, outputs = NMS_STREAMS[name](
        np.random.RandomState(seed))
    return (boxes.astype(np.float32), scores.astype(np.float32), threshold,
            outputs)


def nms_batch(names, seed: int = 0):
    """Several streams as one padded batch: ``boxes [P, N, 4]``, ``scores
    [P, N]`` (-inf padding), the streams' thresholds and output caps."""
    streams = [nms_stream(name, seed) for name in names]
    n = max(s[0].shape[0] for s in streams)
    boxes = np.zeros((len(streams), n, 4), np.float32)
    scores = np.full((len(streams), n), -np.inf, np.float32)
    for p, (b, s, _, _) in enumerate(streams):
        boxes[p, :len(b)] = b
        scores[p, :len(s)] = s
    return boxes, scores, [s[2] for s in streams], [s[3] for s in streams]


# sizes of the seeded NMS sweep: 1 to NMS_MAX_BOXES, around the 32-box
# words of the kernel's bitmask and the detector's 500 and 512
NMS_SWEEP_SIZES = (1, 2, 31, 32, 33, 64, 97, 200, 500, 512, 777, 1024)
NMS_SWEEP_THRESHOLDS = (0.0, 0.3, 0.5, 0.7, 1.0)


def nms_sweep(threshold: float, seed: int = 0):
    """Seeded random NMS problems, one of each size of
    :data:`NMS_SWEEP_SIZES`: ``[(boxes [N, 4], scores [N] float32,
    max_outputs)]``.  Scores rounded to two decimals (ties), a tenth
    dead (-inf), a twentieth of the boxes zero-area and a tenth exact
    copies of another box; caps from 1 to N + 8."""
    rng = np.random.RandomState(seed + int(round(1000 * threshold)))
    out = []
    for n in NMS_SWEEP_SIZES:
        boxes = _random_boxes(rng, n, scale=rng.choice([20.0, 60.0, 120.0]))
        copies = rng.rand(n) < 0.1
        boxes[copies] = boxes[rng.randint(0, n, int(copies.sum()))]
        flat = rng.rand(n) < 0.05
        boxes[flat, 2] = boxes[flat, 0]
        scores = np.round(rng.rand(n), 2)
        scores[rng.rand(n) < 0.1] = -np.inf
        out.append((boxes.astype(np.float32), scores.astype(np.float32),
                    int(rng.randint(1, n + 9))))
    return out


# ----------------------------------------------------------------------
# navigation meshes for the BFS field kernel (csrc/bfs.cu)
# ----------------------------------------------------------------------

def nav_rooms(rng, size: int) -> np.ndarray:
    """A ``size``-cell square navigable map: a 3 x 3 grid of rooms whose
    walls have one doorway each, and scattered clutter."""
    nav = rng.rand(size, size) > 0.01
    for k in (size // 3, 2 * size // 3):
        for lo in range(0, size, size // 3):
            door = lo + rng.randint(0, max(1, size // 3 - size // 12))
            nav[k:k + 3, lo:lo + size // 3] = False
            nav[k:k + 3, door:door + size // 12] = True
            nav[lo:lo + size // 3, k:k + 3] = False
            nav[door:door + size // 12, k:k + 3] = True
    return nav


def nav_meshes(rng, count: int, size: int = 384, step: int = 5):
    """``count`` meshes built and refreshed from :func:`nav_rooms` maps as
    the planner refreshes them (step 5 at 384 cells: 77 x 77 nodes, the
    agent's full width), each seeded around a random cell, stacked:
    (grid, seeds) on the CPU."""
    import torch

    from mass_tpu_torch.nav import grid as NG

    grids, seeds = [], []
    for _ in range(count):
        nav = nav_rooms(rng, size)
        off = rng.randint(0, step, 2)
        grid = NG.build_nav_grid(torch.from_numpy(nav), int(off[0]),
                                 int(off[1]), step=step)
        nav &= rng.rand(size, size) > 0.005
        grid = NG.refresh_nav_grid(grid, NG._navigable(
            torch.from_numpy(~nav), None, 1), step=step)
        grids.append(grid)
        cell = torch.from_numpy(rng.randint(0, size, 2))
        seeds.append(NG.seeds_near_cell(grid, cell, step, 2 * step))
    return NG.stack_grids(grids), torch.stack(seeds)
