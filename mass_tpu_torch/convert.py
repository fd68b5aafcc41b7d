"""Carry state across from the JAX package.

``mass_tpu``'s ``VoxelMap`` stores its features either channel-major
``[8 * ceil(F / 8), V]`` (the TPU layout, with zero pad rows) or
voxel-major ``[V, F]``; the port always stores ``[V, F]``.  The
search policy's flax parameters (``Conv_k`` HWIO kernels, ``GroupNorm_k``
scales and biases) become the reference ``Sequential`` layout that
``search/policy.py`` reads, and the stage-1 ResNet's flax variables the
torchvision-named state dict that ``perception/resnet.py`` reads; the
Mask R-CNN's flax variables become the detectron2-named state dict of
``perception/maskrcnn.py`` (its trainer's gradients and optimizer state
the same names) and the segmentation UNet's parameters the state dict of
``perception/detector.py``.  The functions here take and
give plain numpy arrays, so neither package imports the other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.perception import resnet
from mass_tpu_torch.search import policy as search_policy


def voxelmap_from_jax(data, bins_x, bins_y, bins_z,
                      geometry: MapGeometry, device=None, mesh=None):
    """The port's ``VoxelMap`` holding a JAX map's state, or with a
    ``mesh`` the ``parallel/sharding.ShardedVoxelMap`` over its ``map``
    axis (a JAX sharded map's state arrives whole through numpy, and is
    cut into the port's slabs).

    ``data`` is the JAX map's storage as numpy, in either layout: the
    voxel-major ``[V, F]`` form is taken as is, the channel-major form
    ``[Fpad, V]`` (``Fpad`` = F rounded up to 8) is transposed with its
    pad rows dropped.  The arrays are copied: the port updates its map
    in place.
    """
    g = geometry
    data = np.asarray(data, np.float32)
    fpad = (g.feature_size + 7) // 8 * 8
    if data.shape == (g.num_voxels, g.feature_size):
        vmajor = data
    elif data.shape == (fpad, g.num_voxels):
        vmajor = data[:g.feature_size].T
    else:
        raise ValueError(
            f"map data of shape {data.shape} fits neither [V, F] = "
            f"{(g.num_voxels, g.feature_size)} nor [Fpad, V] = "
            f"{(fpad, g.num_voxels)}")
    if mesh is not None:
        device = mesh.axis_devices("map")[0]
    vm = VoxelMap.create(g, device=device)
    vm.data.copy_(torch.from_numpy(np.array(vmajor, np.float32)))
    for name, bins in (("bins_x", bins_x), ("bins_y", bins_y),
                       ("bins_z", bins_z)):
        getattr(vm, name).copy_(torch.from_numpy(
            np.array(bins, np.float32)))
    if mesh is not None:
        from mass_tpu_torch.parallel.sharding import shard_voxelmap
        return shard_voxelmap(vm, mesh)
    return vm


def voxelmap_to_numpy(vm, layout: str = "vmajor") -> Dict[str, np.ndarray]:
    """Inverse of :func:`voxelmap_from_jax`: the map's ``data`` in the
    JAX ``layout`` ("vmajor" ``[V, F]`` or "cmajor" ``[Fpad, V]`` with
    zero pad rows) and its ``bins_x/y/z``, as numpy; a sharded map's
    slabs are gathered (``grid``)."""
    g = vm.geometry
    data = vm.grid().detach().cpu().numpy().reshape(g.num_voxels,
                                                    g.feature_size)
    if layout == "cmajor":
        fpad = (g.feature_size + 7) // 8 * 8
        cmajor = np.zeros((fpad, g.num_voxels), np.float32)
        cmajor[:g.feature_size] = data.T
        data = cmajor
    elif layout != "vmajor":
        raise ValueError(f"layout must be 'vmajor' or 'cmajor', got "
                         f"{layout!r}")
    return dict(data=data,
                bins_x=vm.bins_x.detach().cpu().numpy(),
                bins_y=vm.bins_y.detach().cpu().numpy(),
                bins_z=vm.bins_z.detach().cpu().numpy())


def policy_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The reference ``policy.pth`` state dict of the JAX package's
    search-policy parameters (``{"params": {...}}`` or the inner dict, as
    numpy): ``Conv_k`` kernels HWIO -> OIHW at Sequential index
    ``(0, 3, 6, 9, 12)[k]``, ``GroupNorm_k`` scale/bias -> weight/bias at
    ``(1, 4, 7, 10)[k]``."""
    params = params.get("params", params)

    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32))
    state = {}
    for k, i in enumerate(search_policy.CONV_INDICES):
        conv = params[f"Conv_{k}"]
        state[f"{i}.weight"] = tensor(
            np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        state[f"{i}.bias"] = tensor(conv["bias"])
    for k, i in enumerate(search_policy.NORM_INDICES):
        norm = params[f"GroupNorm_{k}"]
        state[f"{i}.weight"] = tensor(norm["scale"])
        state[f"{i}.bias"] = tensor(norm["bias"])
    return state


def policy_from_jax(params, device=None) -> search_policy.SearchPolicy:
    """The port's :class:`~mass_tpu_torch.search.policy.SearchPolicy`
    holding the JAX package's search-policy parameters."""
    return search_policy.from_state_dict(policy_state_dict_from_jax(params),
                                         device)


def backbone_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The torchvision-named state dict of the JAX package's stage-1
    ResNet variables (``{"params": ..., "batch_stats": ...}``, as numpy
    or arrays): conv kernels HWIO -> OIHW; batch norm ``scale``/``bias``
    -> ``weight``/``bias`` and ``mean``/``var`` -> ``running_mean``/
    ``running_var``; flax's ``layer1_{b}`` blocks -> ``layer1.{b}``, their
    ``down_conv``/``down_bn`` -> ``downsample.0``/``downsample.1``."""
    params, stats = variables["params"], variables["batch_stats"]

    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32))
    state = {}

    def conv(name, p):
        state[f"{name}.weight"] = tensor(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def norm(name, p, s):
        state[f"{name}.weight"] = tensor(p["scale"])
        state[f"{name}.bias"] = tensor(p["bias"])
        state[f"{name}.running_mean"] = tensor(s["mean"])
        state[f"{name}.running_var"] = tensor(s["var"])
        state[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", params["conv1"])
    norm("bn1", params["bn1"], stats["bn1"])
    for b in range(3):
        p, s = params[f"layer1_{b}"], stats[f"layer1_{b}"]
        for i in (1, 2, 3):
            conv(f"layer1.{b}.conv{i}", p[f"conv{i}"])
            norm(f"layer1.{b}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
        if "down_conv" in p:
            conv(f"layer1.{b}.downsample.0", p["down_conv"])
            norm(f"layer1.{b}.downsample.1", p["down_bn"], s["down_bn"])
    return state


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _conv_weight(node) -> torch.Tensor:
    """A flax conv kernel HWIO -> OIHW."""
    return _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))


def maskrcnn_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The detectron2-named state dict (``perception/maskrcnn.MaskRCNN``'s
    names) of the JAX package's Mask R-CNN variables (``{"params": ...,
    "batch_stats": ...}``, as numpy or arrays): the inverse of
    ``params_from_detectron2``, done as ``export_detectron2_state_dict``
    does it.  Conv kernels HWIO -> OIHW, dense kernels transposed, fc6's
    input axis from flax's ``[S, S, C]`` flattening to torch's
    ``[C, S, S]``, the deconv kernel ``[in, out, 2, 2]`` as it is."""
    return _maskrcnn_tree(variables["params"],
                          variables["batch_stats"]["backbone"])


def maskrcnn_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A pytree shaped as the JAX Mask R-CNN's ``params`` (the parameters,
    their gradients or an optimizer's momentum trace) in the port's
    names: the state dict's trainable entries, by the layout rules of
    :func:`maskrcnn_state_dict_from_jax` (batch norm ``scale``/``bias`` ->
    ``norm.weight``/``norm.bias``; no statistics)."""
    return _maskrcnn_tree(tree.get("params", tree), None)


def maskrcnn_opt_state_from_jax(opt_state) -> Dict:
    """The port's optimizer state (``maskrcnn_train.SGD.state_dict``:
    ``{"momentum": {name: tensor}, "count": int}``) of an optax state of
    ``chain(clip_by_global_norm, sgd(schedule, momentum))``: the
    ``trace`` of its ``TraceState`` and the ``count`` of its schedule."""
    found = {}

    def walk(node):
        if hasattr(node, "_fields"):
            for field in ("trace", "count"):
                if field in node._fields:
                    found[field] = getattr(node, field)
        if isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
    walk(opt_state)
    if set(found) != {"trace", "count"}:
        raise ValueError(f"no momentum trace and schedule count in "
                         f"{type(opt_state).__name__}: found {sorted(found)}")
    return dict(momentum=maskrcnn_params_from_jax(found["trace"]),
                count=int(np.asarray(found["count"])))


def _maskrcnn_tree(p, stats) -> Dict[str, torch.Tensor]:
    """The detectron2-named tensors of a params-shaped pytree ``p``, with
    the batch norms' running statistics from ``stats`` (the backbone's
    ``batch_stats``) unless it is None."""
    sd: Dict[str, torch.Tensor] = {}

    def put_conv(key, node, bias=False):
        sd[f"{key}.weight"] = _conv_weight(node)
        if bias:
            sd[f"{key}.bias"] = _tensor(node["bias"])

    def put_bn(key, bn, st):
        sd[f"{key}.weight"] = _tensor(bn["scale"])
        sd[f"{key}.bias"] = _tensor(bn["bias"])
        if st is not None:
            sd[f"{key}.running_mean"] = _tensor(st["mean"])
            sd[f"{key}.running_var"] = _tensor(st["var"])

    def put_dense(key, node):
        sd[f"{key}.weight"] = _tensor(np.asarray(node["kernel"]).T)
        sd[f"{key}.bias"] = _tensor(node["bias"])

    def stat(*path):
        node = stats
        for name in path:
            node = None if node is None else node[name]
        return node

    bb = p["backbone"]
    put_conv("backbone.bottom_up.stem.conv1", bb["conv1"])
    put_bn("backbone.bottom_up.stem.conv1.norm", bb["bn1"], stat("bn1"))
    for stage, blocks in enumerate(resnet.STAGE_BLOCKS):
        for b in range(blocks):
            name = f"layer{stage + 1}_{b}"
            prefix = f"backbone.bottom_up.res{stage + 2}.{b}"
            for i in (1, 2, 3):
                put_conv(f"{prefix}.conv{i}", bb[name][f"conv{i}"])
                put_bn(f"{prefix}.conv{i}.norm", bb[name][f"bn{i}"],
                       stat(name, f"bn{i}"))
            if b == 0:
                put_conv(f"{prefix}.shortcut", bb[name]["down_conv"])
                put_bn(f"{prefix}.shortcut.norm", bb[name]["down_bn"],
                       stat(name, "down_bn"))
    for i in range(4):
        put_conv(f"backbone.fpn_lateral{i + 2}",
                 p["fpn"][f"lateral{i + 2}"], bias=True)
        put_conv(f"backbone.fpn_output{i + 2}",
                 p["fpn"][f"output{i + 2}"], bias=True)
    rpn = "proposal_generator.rpn_head"
    put_conv(f"{rpn}.conv", p["rpn_head"]["conv"], bias=True)
    put_conv(f"{rpn}.objectness_logits", p["rpn_head"]["objectness"],
             bias=True)
    put_conv(f"{rpn}.anchor_deltas", p["rpn_head"]["deltas"], bias=True)
    fc6 = np.asarray(p["box_head"]["fc6"]["kernel"]).T     # [out, S*S*C]
    out = fc6.shape[0]
    sd["roi_heads.box_head.fc1.weight"] = _tensor(
        fc6.reshape(out, 7, 7, -1).transpose(0, 3, 1, 2).reshape(out, -1))
    sd["roi_heads.box_head.fc1.bias"] = _tensor(
        p["box_head"]["fc6"]["bias"])
    put_dense("roi_heads.box_head.fc2", p["box_head"]["fc7"])
    put_dense("roi_heads.box_predictor.cls_score",
              p["box_predictor"]["cls_score"])
    put_dense("roi_heads.box_predictor.bbox_pred",
              p["box_predictor"]["bbox_pred"])
    mask = p["mask_head"]
    for i in range(4):
        put_conv(f"roi_heads.mask_head.mask_fcn{i + 1}",
                 mask[f"mask_fcn{i + 1}"], bias=True)
    sd["roi_heads.mask_head.deconv.weight"] = _tensor(mask["deconv_kernel"])
    sd["roi_heads.mask_head.deconv.bias"] = _tensor(mask["deconv_bias"])
    put_conv("roi_heads.mask_head.predictor", mask["predictor"], bias=True)
    return sd


def unet_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The port's ``SegmenterUNet`` state dict of the JAX package's UNet
    parameters (``{"params": ...}`` or the inner dict): ``ConvBlock_i``
    -> ``blocks.i`` (``Conv_0/1`` -> ``conv1/2``, ``GroupNorm_0/1`` scale
    and bias -> ``norm1/2`` weight and bias), the last ``Conv_0`` ->
    ``head``."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    blocks = sorted((k for k in params if k.startswith("ConvBlock_")),
                    key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(blocks):
        block = params[name]
        for j in (0, 1):
            sd[f"blocks.{i}.conv{j + 1}.weight"] = _conv_weight(
                block[f"Conv_{j}"])
            norm = block[f"GroupNorm_{j}"]
            sd[f"blocks.{i}.norm{j + 1}.weight"] = _tensor(norm["scale"])
            sd[f"blocks.{i}.norm{j + 1}.bias"] = _tensor(norm["bias"])
    sd["head.weight"] = _conv_weight(params["Conv_0"])
    sd["head.bias"] = _tensor(params["Conv_0"]["bias"])
    return sd
