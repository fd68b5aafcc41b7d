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
"""

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


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in NAMES:
        print(export(name), os.path.getsize(pth_path(name)))
    print(export_backbone(), os.path.getsize(pth_path(BACKBONE)))
