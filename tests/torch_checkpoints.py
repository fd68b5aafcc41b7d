"""Export of the shipped checkpoints for the port.

The JAX package ships its trained policies as orbax trees
(``checkpoints/policy-*``), which only orbax and JAX read.  The port reads
the reference's ``policy.pth`` layout (a torch ``Sequential`` state dict),
so each tree is exported once to
``mass_tpu_torch/checkpoints/policy-*.pth``, and
``tests/test_torch_policy.py`` holds every exported file equal to its
tree.  The feature-matching protocol (``experiments/fm/queue_r5b.sh``)
runs the stage-1 ResNet of ``mass_tpu.perception.resnet.init_backbone()``
(the flax init at ``PRNGKey(0)``); it is exported to
``mass_tpu_torch/checkpoints/backbone-rand.pth`` with torchvision's
names, and ``tests/test_torch_resnet.py`` holds that file equal to the
tree.  This helper imports both packages, so it lives with the tests:

    python -m tests.torch_checkpoints

The learned-segmentation detectors export the same way: ``--detector
<orbax dir> --arch maskrcnn|unet [--out <.pth>]`` writes the port's
``.pth`` of a JAX Mask R-CNN (detectron2 names, ``{"model": sd,
"class_offset": k}``; a 53-class detector records offset 1) or UNet.  The
trained detector is not in the repository, so the port runs on random
detectron2-layout weights made from a seed with numpy, which needs
neither JAX nor orbax:

    python -m tests.torch_checkpoints --random-detector build/maskrcnn-rand.pth
"""

import argparse
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("policy-gridworld", "policy-bigroom", "policy-multiroom",
         "policy-conditioned-multiroom")


def orbax_path(name: str) -> str:
    return os.path.join(REPO, "checkpoints", name)


def pth_path(name: str) -> str:
    return os.path.join(REPO, "mass_tpu_torch", "checkpoints", f"{name}.pth")


def load_orbax(name: str):
    """The orbax tree of a shipped policy, as numpy arrays."""
    import jax
    from mass_tpu.utils.checkpoint import load_pytree

    return jax.tree_util.tree_map(np.asarray, load_pytree(orbax_path(name)))


BACKBONE = "backbone-rand"


def backbone_variables():
    """``init_backbone()``'s variables, as numpy arrays."""
    import jax
    from mass_tpu.perception.resnet import init_backbone

    return jax.tree_util.tree_map(np.asarray, init_backbone())


def export_backbone() -> str:
    from mass_tpu_torch.convert import backbone_state_dict_from_jax

    path = pth_path(BACKBONE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(backbone_state_dict_from_jax(backbone_variables()), path)
    return path


def export(name: str) -> str:
    from mass_tpu_torch.convert import policy_state_dict_from_jax

    path = pth_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(policy_state_dict_from_jax(load_orbax(name)), path)
    return path


# ---------------------------------------------------------------------
# learned-segmentation detectors
# ---------------------------------------------------------------------

_BLOCKS = (3, 4, 6, 3)
_WIDTHS = (64, 128, 256, 512)

# A random detectron2-layout network amplifies a 224x224 grid-world frame
# (x255, mean-subtracted) to activations of order 3e5 at every head, all
# of the box head's features positive.  The output layers are scaled
# (their biases set to 0), the box predictor's rows first centred (their
# mean over the inputs taken out, so the features' common part picks no
# class): anchor deltas come out with a spread of about 0.06, boxes stay
# on the image, the best softmax scores of a frame lie near 0.3-0.45, a
# few classes win, and masks are neither empty nor full.
HEAD_SCALES = {"proposal_generator.rpn_head.anchor_deltas": 1e-7,
               "roi_heads.box_predictor.bbox_pred": 3e-6,
               "roi_heads.box_predictor.cls_score": 1e-5,
               "roi_heads.mask_head.predictor": 5e-6}
CENTRED = ("roi_heads.box_predictor.bbox_pred",
           "roi_heads.box_predictor.cls_score")


def random_maskrcnn_state_dict(seed: int = 0, num_classes: int = 54,
                               tempered: bool = True):
    """A detectron2-layout Mask R-CNN state dict of random weights drawn
    with ``np.random.RandomState(seed)``: the draws of
    ``tests/test_maskrcnn.py``'s ``_rand_d2_state_dict`` in the same order
    (equal to it when ``tempered`` is False), then, when ``tempered``,
    the output layers scaled by ``HEAD_SCALES`` (``CENTRED`` rows centred
    first) and their biases zeroed."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(key, cout, cin, k, bias=False, norm=True):
        w = rng.normal(0, np.sqrt(2.0 / (cin * k * k)), (cout, cin, k, k))
        sd[f"{key}.weight"] = torch.tensor(w, dtype=torch.float32)
        if bias:
            sd[f"{key}.bias"] = torch.tensor(rng.normal(0, 0.01, cout),
                                             dtype=torch.float32)
        if norm:
            sd[f"{key}.norm.weight"] = torch.tensor(
                rng.uniform(0.9, 1.1, cout), dtype=torch.float32)
            sd[f"{key}.norm.bias"] = torch.tensor(
                rng.normal(0, 0.01, cout), dtype=torch.float32)
            sd[f"{key}.norm.running_mean"] = torch.tensor(
                rng.normal(0, 0.01, cout), dtype=torch.float32)
            sd[f"{key}.norm.running_var"] = torch.tensor(
                rng.uniform(0.5, 1.5, cout), dtype=torch.float32)

    def dense(key, cout, cin):
        sd[f"{key}.weight"] = torch.tensor(
            rng.normal(0, np.sqrt(1.0 / cin), (cout, cin)),
            dtype=torch.float32)
        sd[f"{key}.bias"] = torch.tensor(rng.normal(0, 0.01, cout),
                                         dtype=torch.float32)

    conv("backbone.bottom_up.stem.conv1", 64, 3, 7)
    cin = 64
    for s in range(4):
        w = _WIDTHS[s]
        for b in range(_BLOCKS[s]):
            pre = f"backbone.bottom_up.res{s + 2}.{b}"
            conv(f"{pre}.conv1", w, cin if b == 0 else w * 4, 1)
            conv(f"{pre}.conv2", w, w, 3)
            conv(f"{pre}.conv3", w * 4, w, 1)
            if b == 0:
                conv(f"{pre}.shortcut", w * 4, cin, 1)
                cin = w * 4
    for i in range(4):
        conv(f"backbone.fpn_lateral{i + 2}", 256, _WIDTHS[i] * 4, 1,
             bias=True, norm=False)
        conv(f"backbone.fpn_output{i + 2}", 256, 256, 3, bias=True,
             norm=False)
    conv("proposal_generator.rpn_head.conv", 256, 256, 3, bias=True,
         norm=False)
    conv("proposal_generator.rpn_head.objectness_logits", 3, 256, 1,
         bias=True, norm=False)
    conv("proposal_generator.rpn_head.anchor_deltas", 12, 256, 1,
         bias=True, norm=False)
    dense("roi_heads.box_head.fc1", 1024, 256 * 7 * 7)
    dense("roi_heads.box_head.fc2", 1024, 1024)
    dense("roi_heads.box_predictor.cls_score", num_classes + 1, 1024)
    dense("roi_heads.box_predictor.bbox_pred", num_classes * 4, 1024)
    for i in range(4):
        conv(f"roi_heads.mask_head.mask_fcn{i + 1}", 256, 256, 3,
             bias=True, norm=False)
    sd["roi_heads.mask_head.deconv.weight"] = torch.tensor(
        rng.normal(0, np.sqrt(2.0 / 256), (256, 256, 2, 2)),
        dtype=torch.float32)
    sd["roi_heads.mask_head.deconv.bias"] = torch.tensor(
        rng.normal(0, 0.01, 256), dtype=torch.float32)
    conv("roi_heads.mask_head.predictor", num_classes, 256, 1, bias=True,
         norm=False)
    if tempered:
        for key, scale in HEAD_SCALES.items():
            w = sd[f"{key}.weight"]
            if key in CENTRED:
                w = w - w.mean(1, keepdim=True)
            sd[f"{key}.weight"] = w * scale
            sd[f"{key}.bias"] = torch.zeros_like(sd[f"{key}.bias"])
    return sd


def write_random_detector(path: str, seed: int = 0,
                          num_classes: int = 54) -> str:
    """Write :func:`random_maskrcnn_state_dict` as a detectron2
    ``model_final.pth`` (``{"model": sd}``) at ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": random_maskrcnn_state_dict(seed, num_classes)},
               path)
    return path


def export_detector(path: str, arch: str, out: str) -> str:
    """Export a JAX detector's orbax tree to the port's ``.pth``: a Mask
    R-CNN (``--detector-num-classes`` inferred from the tree; 53 classes
    record ``class_offset`` 1, as ``mass_tpu.agent.cli`` applies it) or
    the segmentation UNet."""
    import jax
    from mass_tpu.utils.checkpoint import load_pytree
    from mass_tpu_torch import convert

    tree = jax.tree_util.tree_map(np.asarray, load_pytree(path))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    if arch == "unet":
        torch.save(convert.unet_state_dict_from_jax(tree), out)
        return out
    sd = convert.maskrcnn_state_dict_from_jax(tree)
    classes = sd["roi_heads.box_predictor.cls_score.weight"].shape[0] - 1
    torch.save({"model": sd, "class_offset": 1 if classes < 54 else 0},
               out)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser("python -m tests.torch_checkpoints")
    parser.add_argument("--detector", default=None,
                        help="orbax tree of a JAX detector to export")
    parser.add_argument("--arch", default="maskrcnn",
                        choices=["maskrcnn", "unet"])
    parser.add_argument("--out", default=None,
                        help="the .pth to write (default: under "
                             "mass_tpu_torch/checkpoints/)")
    parser.add_argument("--random-detector", default=None, metavar="PTH",
                        help="write a random detectron2-layout Mask R-CNN")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-classes", type=int, default=54)
    args = parser.parse_args()
    if args.random_detector:
        path = write_random_detector(args.random_detector, args.seed,
                                     args.num_classes)
        print(path, os.path.getsize(path))
    elif args.detector:
        import jax

        jax.config.update("jax_platforms", "cpu")
        out = args.out or pth_path(os.path.basename(
            os.path.normpath(args.detector)))
        print(export_detector(args.detector, args.arch, out),
              os.path.getsize(out))
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        for name in NAMES:
            print(export(name), os.path.getsize(pth_path(name)))
        print(export_backbone(), os.path.getsize(pth_path(BACKBONE)))
