"""The port's stage-1 ResNet (``perception/resnet.py``) against the JAX
package's ``ResNet50Stage1`` on the same weights and frames, the weight
converter, the shipped ``backbone-rand.pth`` and the torchvision-named
state dict it reads."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mass_tpu.perception import resnet as RN
from mass_tpu_torch.convert import backbone_state_dict_from_jax
from mass_tpu_torch.perception import resnet as TR
from tests import torch_checkpoints as TC

# the JAX package holds its own backbone to torchvision's at this
# tolerance (tests/test_perception.py); the two frameworks sum each
# conv's products in another order
ATOL = 2e-4


def _random_variables(seed: int):
    """Flax stage-1 variables with random weights and non-trivial batch
    statistics, as numpy arrays."""
    variables = RN.ResNet50Stage1().init(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda x: x.copy(), variables["batch_stats"])

    def jitter(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                jitter(value)
            elif key == "mean":
                tree[key] = rng.uniform(-0.5, 0.5, value.shape).astype(
                    np.float32)
            elif key == "var":
                tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(
                    np.float32)
    jitter(stats)
    return {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("size", [32, 48])
def test_backbone_matches_jax(size):
    variables = _random_variables(size)
    img = np.random.RandomState(size + 1).rand(2, size, size, 3).astype(
        np.float32)
    ref = np.asarray(RN.ResNet50Stage1().apply(variables, jnp.asarray(img)))
    module = TR.from_state_dict(backbone_state_dict_from_jax(variables),
                                device="cpu")
    backbone = TR.make_backbone(module)
    got = backbone(torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape == (2, size // 4, size // 4, 256)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # one frame without the batch axis, as FeatureMap calls it
    one = backbone(torch.from_numpy(img[1])).numpy()
    np.testing.assert_allclose(one, ref[1], atol=ATOL)


def test_shipped_backbone_equals_init_backbone():
    """backbone-rand.pth holds init_backbone()'s tree bit for bit under
    torchvision's names, and loads into the port's module."""
    state = torch.load(TC.pth_path(TC.BACKBONE), weights_only=True)
    want = backbone_state_dict_from_jax(TC.backbone_variables())
    assert sorted(state) == sorted(want)
    for key in want:
        assert state[key].dtype == want[key].dtype, key
        assert torch.equal(state[key], want[key]), key
    floats = sum(v.numel() for v in state.values()
                 if v.dtype == torch.float32)
    assert floats == 228288
    assert os.path.getsize(TC.pth_path(TC.BACKBONE)) < 1 << 20
    backbone, module = TR.load_backbone_checkpoint(
        TC.pth_path(TC.BACKBONE), device="cpu")
    assert sorted(module.state_dict()) == sorted(state)


def test_converter_names_and_layouts():
    variables = _random_variables(5)
    state = backbone_state_dict_from_jax(variables)
    params, stats = variables["params"], variables["batch_stats"]
    np.testing.assert_array_equal(
        state["conv1.weight"].numpy(),
        params["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["layer1.0.downsample.0.weight"].numpy(),
        params["layer1_0"]["down_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["layer1.2.bn3.running_var"].numpy(),
                                  stats["layer1_2"]["bn3"]["var"])
    np.testing.assert_array_equal(state["layer1.1.bn2.weight"].numpy(),
                                  params["layer1_1"]["bn2"]["scale"])
    assert "layer1.1.downsample.0.weight" not in state
    # the JAX package's own torchvision import inverts the converter
    back = RN.params_from_torchvision(
        {k: v.numpy() for k, v in state.items()})
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torchvision_state_dict_loads_as_is(tmp_path):
    """A resnet50 state dict with later stages (and a fc head) loads: the
    stage-1 entries are taken; one that lacks an entry is refused."""
    state = backbone_state_dict_from_jax(_random_variables(6))
    full = dict(state)
    full["layer2.0.conv1.weight"] = torch.zeros(128, 256, 1, 1)
    full["fc.weight"] = torch.zeros(1000, 2048)
    path = tmp_path / "resnet50.pth"
    torch.save(full, path)
    _, module = TR.load_backbone_checkpoint(str(path), device="cpu")
    for key, value in state.items():
        assert torch.equal(module.state_dict()[key], value), key
    del full["layer1.0.bn1.running_mean"]
    with pytest.raises(ValueError, match="layer1.0.bn1.running_mean"):
        TR.from_state_dict(full, device="cpu")


def test_feature_flops_count_the_convs():
    """The convs' operations of one frame, counted layer by layer from
    the module's own shapes."""
    module = TR.ResNet50Stage1()
    macs = 0
    x = torch.zeros(1, 64, 64, 3)
    hooks = []

    def count(conv, inputs, output):
        nonlocal macs
        k = conv.kernel_size[0] * conv.kernel_size[1]
        macs += output.numel() * conv.in_channels * k

    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(count))
    module(x)
    assert TR.feature_flops(64, 64) == 2 * macs
    # the full-width camera: about 1.6 GFLOP
    assert 1.5e9 < TR.feature_flops(224, 224) < 1.7e9
