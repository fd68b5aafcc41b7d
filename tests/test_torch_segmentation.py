"""The port's segmentation sources (``mass_tpu_torch.perception.
segmentation`` and ``detector``) against the JAX package's on the same
inputs: mask fusion (exact), color lookup (exact), the UNet's logits
(within 1e-4), instances from logits, the batched sensor against the
per-frame one, the sampler wrapper, and the CLI's learned-segmentation
flags."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mass_tpu import taxonomy as jtaxonomy
from mass_tpu.perception import detector as JDet
from mass_tpu.perception import segmentation as JS
from mass_tpu_torch import convert
from mass_tpu_torch.perception import detector as TDet
from mass_tpu_torch.perception import maskrcnn as TM
from mass_tpu_torch.perception import segmentation as TS
from tests import torch_checkpoints as TC
from tests import torch_margins

# the small detector of the tests: tests/test_maskrcnn.py's SMALL caps at
# a 48 px camera, 7 classes from the tempered random weights; its scores
# lie near 0.21-0.29, so a fusion threshold of 0.2 keeps detections
SMALL48 = TM.MaskRCNNConfig(num_classes=7, image_size=48, pre_nms_topk=64,
                            post_nms_topk=32, candidate_pool=64,
                            max_detections=8)
THRESHOLD = 0.2


def _detections(rng, k=6, h=10, w=12, num_classes=9):
    masks = (rng.rand(k, h, w) < 0.4).astype(np.float32)
    classes = rng.randint(-1, num_classes + 1, k).astype(np.int32)
    scores = rng.rand(k).astype(np.float32)
    return masks, classes, scores


@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.9])
def test_detections_to_semantic_matches_jax(threshold):
    rng = np.random.RandomState(0)
    masks, classes, scores = _detections(rng)
    scores[2] = threshold                     # exactly at the threshold
    want = np.asarray(JS.detections_to_semantic(
        JS.Detections(jnp.asarray(masks), jnp.asarray(classes),
                      jnp.asarray(scores)), threshold, 9))
    det = TS.Detections(torch.from_numpy(masks), torch.from_numpy(classes),
                        torch.from_numpy(scores))
    got = TS.detections_to_semantic(det, threshold, 9)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of two frames fuses each frame alone
    two = TS.detections_to_semantic(
        TS.Detections(*(torch.stack([t, t]) for t in det)), threshold, 9)
    assert torch.equal(two[1], got)


def test_detections_to_semantic_tta_matches_jax():
    rng = np.random.RandomState(1)
    sets = [_detections(rng) for _ in range(3)]
    want = np.asarray(JS.detections_to_semantic_tta(
        [JS.Detections(*(jnp.asarray(x) for x in s)) for s in sets], 0.3,
        9))
    got = TS.detections_to_semantic_tta(
        [TS.Detections(*(torch.from_numpy(x) for x in s)) for s in sets],
        0.3, 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_colors_to_classes_matches_jax():
    colors = jtaxonomy.class_colors_array(normalized=False).astype(np.uint8)
    rng = np.random.RandomState(2)
    frame = colors[rng.randint(0, len(colors), (9, 7))]
    frame[0, :3] = [1, 2, 3]                     # colors of no class
    frame[4, 4] = colors[0]
    want = np.asarray(JS.colors_to_classes(jnp.asarray(frame)))
    got = TS.colors_to_classes(frame)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (TS.GroundTruthSegmentation()({"semantic_colors": frame})
            == want).all()


@pytest.fixture(scope="module")
def unet():
    """The JAX package's ``init_segmenter`` UNet (PRNGKey 0) at 48 px and
    the port's copy of it."""
    model, params = JDet.init_segmenter(jax.random.PRNGKey(0), 48)
    state = convert.unet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    return model, params, TDet.from_state_dict(state, "cpu"), state


def test_unet_logits_match_jax(unet):
    model, params, port, _ = unet
    rgb = np.random.RandomState(3).rand(2, 48, 48, 3).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(rgb)))
    with torch.no_grad():
        got = port(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    sensor = TDet.make_segmentation_sensor(port)
    jsensor = JDet.make_segmentation_sensor(params)
    out = sensor({"rgb": rgb[0]})
    assert out.shape == (48, 48, 1) and out.dtype == np.int32
    top2 = np.sort(want[0], -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2e-4
    np.testing.assert_array_equal(out[..., 0][decided],
                                  jsensor({"rgb": rgb[0]})[..., 0][decided])


def test_instances_from_logits_matches_jax():
    h = w = 24
    classes = np.zeros((h, w), np.int64)
    classes[2:8, 2:8] = 5
    classes[14:20, 10:22] = 9
    classes[10:12, 0:3] = 3
    classes[20:23, 1:4] = 5
    rng = np.random.RandomState(4)
    logits = rng.normal(0, 0.3, (h, w, 12)).astype(np.float32)
    logits[np.arange(h)[:, None], np.arange(w)[None, :], classes] += 4.0
    want = JDet.instances_from_logits(jnp.asarray(logits), max_instances=8)
    got = TDet.instances_from_logits(torch.from_numpy(logits),
                                     max_instances=8)
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6)
    assert (got.scores > 0).sum() == 4
    sem = TS.detections_to_semantic(got, 0.5, 12)[..., 0].numpy()
    np.testing.assert_array_equal(sem, classes)


@pytest.fixture(scope="module")
def small_detector():
    model = TM.from_state_dict(TC.random_maskrcnn_state_dict(0, 7),
                               SMALL48, "cpu")
    return TM.make_detector(model, class_offset=1)


def _frames(n):
    from mass_tpu_torch.config import CameraConfig
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    task = GridWorldTaskSampler([2], camera=CameraConfig(48, 48),
                                num_objects=2, num_misplaced=1,
                                num_opened=0).next_task()
    out = []
    for k in range(n):
        out.append(np.asarray(task.get_observations()["rgb"], np.float32))
        task.step(1 + k % 2)
    return np.stack(out)


def test_batched_sensor_equals_per_frame(small_detector):
    """One call on a fleet's frames (a finished episode's frame riding as
    zeros) gives each frame's own class image; detections survive the
    threshold."""
    sensor = TS.DetectorSegmentation(small_detector, THRESHOLD)
    frames = _frames(3)
    frames[1] = 0.0
    batched = TS.make_batched_sensor(sensor)(frames)
    assert batched.shape == (3, 48, 48, 1) and batched.dtype == np.int32
    for b in range(3):
        one = sensor({"rgb": frames[b]})
        det, probs = TM.detect(
            small_detector.model, torch.from_numpy(frames[b]),
            TM.device_anchors(SMALL48, "cpu"), with_probs=True)
        differing, unexplained = torch_margins.compare_semantic(
            one, batched[b], det, probs, THRESHOLD)
        assert unexplained == 0, (b, differing)
    fused = (batched[0] > 0).sum()
    print(f"fused non-zero pixels of frame 0 at {THRESHOLD}: {fused}")
    assert fused > 0
    looped = TS.make_batched_sensor(lambda obs: sensor(obs))(frames)
    np.testing.assert_array_equal(looped[2], sensor({"rgb": frames[2]}))


class _FakeTask:
    def __init__(self):
        self.stepped = []

    def get_observations(self):
        return {"rgb": np.zeros((4, 4, 3), np.float32),
                "semantic": np.ones((4, 4, 1), np.int32)}

    def step(self, action):
        self.stepped.append(action)

    def is_done(self):
        return False


class _FakeSampler:
    def __init__(self):
        self.skipped = 0
        self.label = "fake"

    def next_task(self):
        return _FakeTask()

    def skip_task(self):
        self.skipped += 1


def test_sampler_wrapper_replaces_semantic_and_delegates():
    calls = []

    def sensor(obs):
        calls.append(obs)
        return np.full((4, 4, 1), 7, np.int32)

    inner = _FakeSampler()
    sampler = TS.SegmentationSampler(inner, sensor)
    task = sampler.next_task()
    obs = task.get_observations()
    assert (obs["semantic"] == 7).all() and (obs["gt_semantic"] == 1).all()
    assert "gt_semantic" in calls[0]
    task.step(3)
    assert task._task.stepped == [3] and not task.is_done()
    sampler.skip_task()
    assert inner.skipped == 1 and sampler.label == "fake"


def _args(tmp_path, *flags):
    from mass_tpu_torch.agent import cli
    return cli.build_parser().parse_args(
        ["--logdir", str(tmp_path), "--camera-size", "48", *flags])


def test_cli_builds_sensors_from_pth(tmp_path, unet):
    from mass_tpu_torch.agent import cli
    path = TC.write_random_detector(str(tmp_path / "maskrcnn.pth"), 0, 54)
    sensor = cli.load_segmentation_sensor(
        _args(tmp_path, "--detector-checkpoint", path,
              "--detection-threshold", "0.3"), "cpu")
    assert isinstance(sensor, TS.DetectorSegmentation)
    assert sensor.detection_threshold == 0.3
    assert sensor.model.model.config.num_classes == 54
    unet_path = str(tmp_path / "unet.pth")
    torch.save(unet[3], unet_path)
    unet_sensor = cli.load_segmentation_sensor(
        _args(tmp_path, "--detector-checkpoint", unet_path,
              "--detector-arch", "unet"), "cpu")
    out = unet_sensor({"rgb": np.zeros((48, 48, 3), np.float32)})
    assert out.shape == (48, 48, 1)
    assert cli.load_segmentation_sensor(
        _args(tmp_path, "--ground-truth-segmentation"), "cpu") is None


def test_cli_needs_a_pth_detector(tmp_path):
    """No checkpoint stops naming the flag (as the JAX CLI does); an orbax
    directory is refused naming the export command."""
    from mass_tpu_torch.agent import cli
    with pytest.raises(SystemExit, match="--detector-checkpoint"):
        cli.load_segmentation_sensor(_args(tmp_path), "cpu")
    orbax = os.path.join("checkpoints", "maskrcnn-gridworld")
    for arch in ("maskrcnn", "unet"):
        with pytest.raises(SystemExit, match="python -m "
                           "tests.torch_checkpoints --detector "
                           f".*--arch {arch}"):
            cli.load_segmentation_sensor(
                _args(tmp_path, "--detector-checkpoint", orbax,
                      "--detector-arch", arch), "cpu")


def test_orbax_detectors_export_to_the_ports_pth(tmp_path, unet):
    """``python -m tests.torch_checkpoints --detector <dir> --arch ...``:
    an orbax UNet exports to the port's state dict, and a 53-class orbax
    Mask R-CNN to its detectron2-named dict with ``class_offset`` 1,
    which the port's loader applies."""
    from mass_tpu.perception import maskrcnn as JM
    from mass_tpu.utils.checkpoint import save_pytree
    from tests.test_maskrcnn import _rand_d2_state_dict

    _, params, _, state = unet
    save_pytree(str(tmp_path / "unet"), params)
    out = TC.export_detector(str(tmp_path / "unet"), "unet",
                             str(tmp_path / "unet.pth"))
    got = torch.load(out, weights_only=True)
    assert set(got) == set(state)
    assert all(torch.equal(got[k], state[k]) for k in state)

    sd = _rand_d2_state_dict(np.random.RandomState(1), 53)
    cfg = JM.MaskRCNNConfig(num_classes=53, image_size=48)
    save_pytree(str(tmp_path / "maskrcnn"),
                JM.params_from_detectron2(sd, cfg))
    out = TC.export_detector(str(tmp_path / "maskrcnn"), "maskrcnn",
                             str(tmp_path / "maskrcnn.pth"))
    ckpt = torch.load(out, weights_only=True)
    assert ckpt["class_offset"] == 1
    assert all(torch.equal(ckpt["model"][k], sd[k]) for k in sd)
    _, config, offset = TM.load_torch_checkpoint(out)
    assert offset == 1 and config.bgr
