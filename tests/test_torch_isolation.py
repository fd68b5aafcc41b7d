"""mass_tpu_torch stands alone: every module imports in a process where
``jax`` and ``mass_tpu`` cannot be imported, and so does chip_smoke.py;
its kernels build from plain CUDA sources of their own."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mass_tpu")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import mass_tpu_torch
    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(mass_tpu_torch.__path__,
                                              "mass_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap, apply_onehot_group
    from mass_tpu_torch.ops import splat
    for entry in ("apply_records", "apply_records_multi",
                  "apply_frame_records", "sorted_records_multi",
                  "sorted_frame_records",
                  "splat_onehot_multi_reference",
                  "splat_onehot_frames_reference"):
        assert callable(getattr(splat, entry)), entry
    assert callable(VoxelMap.update_classes_frames)
    from mass_tpu_torch.nav.grid import plan_batch, stack_grids
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator
    from mass_tpu_torch.parallel.fleet import FleetMaps
    assert "mass_tpu_torch.parallel.fleet" in names
    assert "mass_tpu_torch.parallel.evaluator" in names
    for entry in (plan_batch, stack_grids, FleetEvaluator.run,
                  FleetMaps.update_batch):
        assert callable(entry), entry
    from mass_tpu_torch.agent.loop import OnePhaseMapSet
    from mass_tpu_torch.convert import policy_from_jax
    from mass_tpu_torch.match.revisit import pick_site, walkthrough_sites
    from mass_tpu_torch.nav.grid import frontier_mass
    from mass_tpu_torch.search import policy, prng
    for name in ("mass_tpu_torch.search.prng",
                 "mass_tpu_torch.search.policy",
                 "mass_tpu_torch.match.revisit"):
        assert name in names, name
    for entry in (OnePhaseMapSet.update_group, policy_from_jax, pick_site,
                  walkthrough_sites, frontier_mass, policy.SearchPolicy,
                  policy.load_reference_policy, prng.categorical,
                  prng.uniform):
        assert callable(entry), entry
    from mass_tpu_torch.convert import backbone_state_dict_from_jax
    from mass_tpu_torch.maps import ClipMap, FeatureMap
    from mass_tpu_torch.match.find import pooled_features
    from mass_tpu_torch.perception import resnet
    assert "mass_tpu_torch.perception.resnet" in names
    for entry in ("apply_dense_records", "sorted_dense_records",
                  "splat_dense", "splat_dense_reference"):
        assert callable(getattr(splat, entry)), entry
    for entry in (backbone_state_dict_from_jax, ClipMap, FeatureMap,
                  pooled_features, VoxelMap.update, FleetMaps.update_dense,
                  resnet.ResNet50Stage1, resnet.load_backbone_checkpoint,
                  resnet.make_backbone):
        assert callable(entry), entry
    backbone, _ = resnet.load_backbone_checkpoint(
        "mass_tpu_torch/checkpoints/backbone-rand.pth", "cpu")
    from mass_tpu_torch.convert import (maskrcnn_state_dict_from_jax,
                                        unet_state_dict_from_jax)
    from mass_tpu_torch.ops import detection
    from mass_tpu_torch.perception import detector, maskrcnn, segmentation
    for name in ("mass_tpu_torch.ops.detection",
                 "mass_tpu_torch.perception.maskrcnn",
                 "mass_tpu_torch.perception.segmentation",
                 "mass_tpu_torch.perception.detector"):
        assert name in names, name
    for entry in (detection.nms, detection.nms_reference, detection.box_iou,
                  detection.roi_align, maskrcnn.MaskRCNN, maskrcnn.detect,
                  maskrcnn.load_torch_checkpoint, maskrcnn.make_detector,
                  segmentation.detections_to_semantic,
                  segmentation.make_batched_sensor,
                  segmentation.SegmentationSampler, detector.SegmenterUNet,
                  detector.instances_from_logits,
                  maskrcnn_state_dict_from_jax, unet_state_dict_from_jax,
                  resnet.ResNet50):
        assert callable(entry), entry
    from mass_tpu_torch.perception import train_detector
    from mass_tpu_torch.search import dataset, train
    from mass_tpu_torch.tools import detector_dataset, search_labels
    from mass_tpu_torch.utils import checkpoint, training
    for name in ("mass_tpu_torch.utils.checkpoint",
                 "mass_tpu_torch.utils.training",
                 "mass_tpu_torch.search.train",
                 "mass_tpu_torch.search.dataset",
                 "mass_tpu_torch.tools.search_labels",
                 "mass_tpu_torch.tools.detector_dataset",
                 "mass_tpu_torch.perception.train_detector"):
        assert name in names, name
    for entry in (checkpoint.save_state_dict, checkpoint.load_state_dict,
                  training.flax_init_, training.exact_convs,
                  policy.init_policy, detector.init_segmenter,
                  train.create_train_state, train.goal_cross_entropy,
                  train.train_step, train.load_dataset,
                  train.load_dataset_conditioned, train.goal_distance,
                  train._device_dihedral, train._assemble_conditioned,
                  train.fit, train.main, dataset.collect_task,
                  dataset.small_scene_config, dataset.main,
                  search_labels.dump_labels, search_labels.main,
                  detector_dataset.generate, detector_dataset.format_dataset,
                  detector_dataset.record_from_frame, detector_dataset.main,
                  train_detector.load_split, train_detector.batches,
                  train_detector.class_weights,
                  train_detector.make_train_step, train_detector.evaluate,
                  train_detector.train, train_detector.main):
        assert callable(entry), entry
    from mass_tpu_torch.convert import (maskrcnn_opt_state_from_jax,
                                        maskrcnn_params_from_jax)
    from mass_tpu_torch.perception import maskrcnn_train
    assert "mass_tpu_torch.perception.maskrcnn_train" in names
    for entry in (prng.fold_in, maskrcnn.encode_boxes,
                  maskrcnn_params_from_jax, maskrcnn_opt_state_from_jax,
                  training.truncated_normal_, maskrcnn_train.TrainConfig,
                  maskrcnn_train.init_maskrcnn,
                  maskrcnn_train.train_norm_affines_,
                  maskrcnn_train.load_weights, maskrcnn_train.sample_eligible,
                  maskrcnn_train.rpn_targets, maskrcnn_train.rpn_samples,
                  maskrcnn_train.roi_samples, maskrcnn_train.sample_targets,
                  maskrcnn_train.image_losses, maskrcnn_train.batch_loss,
                  maskrcnn_train.SGD, maskrcnn_train.make_train_step,
                  maskrcnn_train.rasterize_record,
                  maskrcnn_train.load_instance_split,
                  maskrcnn_train.flip_batch, maskrcnn_train.evaluate_fused,
                  maskrcnn_train.train, maskrcnn_train.main):
        assert callable(entry), entry
    from mass_tpu_torch.agent import cli as agent_cli
    from mass_tpu_torch.env import _thor_config, replay, thor
    from mass_tpu_torch.tools import (analyze, color_mappings, submission,
                                      visualize_dataset)
    from mass_tpu_torch.utils import visualization
    for name in ("mass_tpu_torch.utils.visualization",
                 "mass_tpu_torch.env.replay", "mass_tpu_torch.env.thor",
                 "mass_tpu_torch.env._thor_config",
                 "mass_tpu_torch.tools.analyze",
                 "mass_tpu_torch.tools.submission",
                 "mass_tpu_torch.tools.color_mappings",
                 "mass_tpu_torch.tools.visualize_dataset"):
        assert name in names, name
    for entry in (visualization.render_occupancy,
                  visualization.render_semantic,
                  visualization.render_feature_query,
                  visualization.episode_frame, agent_cli.make_video_factory,
                  agent_cli.VideoWriter, agent_cli.thor_sampler,
                  replay.TrajectoryRecorder, replay.ReplayTask,
                  replay.record_episode, replay.scripted_actions,
                  replay.pose_to_map_args, replay.replay_digest,
                  replay.diff_captures, replay.main, thor.ThorTask,
                  thor.ThorTaskSampler, _thor_config.build_task_sampler,
                  analyze.main, submission.main, color_mappings.main,
                  visualize_dataset.main):
        assert callable(entry), entry
    from mass_tpu_torch.parallel import (BatchedMapper, episodes, mesh,
                                         shard_voxelmap, sharded_update_fn,
                                         sharding)
    for name in ("mass_tpu_torch.parallel.mesh",
                 "mass_tpu_torch.parallel.sharding",
                 "mass_tpu_torch.parallel.episodes"):
        assert name in names, name
    for entry in (mesh.make_mesh, mesh.data_map_mesh, mesh.DeviceMesh,
                  sharding.ShardedVoxelMap, shard_voxelmap,
                  sharded_update_fn, BatchedMapper, episodes.BatchedMapper,
                  splat.rebase_records, training.Replicas,
                  training.data_devices, training.largest_divisor,
                  maskrcnn_train.frame_losses):
        assert callable(entry), entry
    from mass_tpu_torch.utils import profiling
    assert "mass_tpu_torch.utils.profiling" in names
    for entry in (profiling.trace, profiling.block, profiling.read_trace,
                  profiling.kernel_durations, profiling.device_summary,
                  profiling.unrecorded_launches, profiling.retried,
                  profiling.IncompleteTrace):
        assert callable(entry), entry
    cpu4 = mesh.make_mesh((4,), ("map",), ["cpu"] * 4)
    assert sharding.ShardedVoxelMap.create(
        MapGeometry(map_height=8, map_width=4, map_depth=2),
        cpu4.axis_devices("map")).slabs()[1][0] == 16
    for gated in ("ai2thor", "rearrange", "baseline_configs", "imageio",
                  "matplotlib", "pandas"):
        assert gated not in sys.modules, gated
    import tests.torch_checkpoints, tests.torch_margins, tests.torch_streams
    import tests.torch_fake_thor
    assert callable(tests.torch_margins.compare_train_targets)
    print(len(names))
""")


def test_port_imports_without_jax_or_mass_tpu():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 35


def test_kernel_sources_stand_alone():
    """Every kernel the port builds has its CUDA source in the package,
    with a plain C interface (no PyTorch or JAX header, so nvcc builds it
    in seconds) and its launch and limit entry points.  The single-map,
    multi-map and frames kernels share one source and one library; the
    dense-row splat (the counterpart of an XLA scatter, not of a TPU
    kernel), the detector's greedy NMS (the counterpart of a
    ``fori_loop``) and the planner's BFS field (the counterpart of a
    ``while_loop``) have their own."""
    from mass_tpu_torch.ops import splat

    assert splat.KERNELS == ("splat_onehot", "splat_onehot_multi",
                             "splat_onehot_frames", "splat_dense", "nms",
                             "bfs")
    assert splat.LIBRARIES == ("splat_onehot", "splat_dense", "nms", "bfs")
    assert {lib for lib, _ in splat._ENTRIES.values()} == set(
        splat.LIBRARIES)
    for gone in ("splat_onehot_multi.cu", "splat_onehot_frames.cu"):
        assert not os.path.exists(os.path.join(
            REPO, "mass_tpu_torch", "csrc", gone))
    replaces = {"splat_onehot": "mass_tpu/ops/pallas_splat.py",
                "splat_dense": "mass_tpu/ops/scatter.py",
                "nms": "mass_tpu/ops/detection.py",
                "bfs": "mass_tpu/nav/grid.py"}
    for name in splat.LIBRARIES:
        source, library = splat._paths(name)
        with open(source) as f:
            text = f.read()
        assert "#include <torch" not in text and "ATen" not in text
        assert replaces[name] in text                   # what it replaces
        kernels = [k for k, (lib, _) in splat._ENTRIES.items()
                   if lib == name]
        for entry in [f"{k}_launch(" for k in kernels] + [
                f"{query}(" for query in splat._LIMITS[name]]:
            assert f'extern "C" int {entry}' in text, (name, entry)
        assert library.endswith(f"build/kernels/lib{name}.so")
    with open(splat._paths("splat_onehot")[0]) as f:
        assert 'extern "C" int splat_onehot_tile(' in f.read()
    with open(splat._paths("nms")[0]) as f:
        text = f.read()
    for entry in ("nms_config(", "nms_step_probe("):
        assert f'extern "C" int {entry}' in text, entry
