"""Walkthrough-site revisit goals (port of ``mass_tpu.match.revisit``).

The unshuffle phase sends its exploration goals to the object sites of
the finished walkthrough map, localized by the matcher's own
``find_all_classes``: an object missing from its walkthrough site is
half of a difference pair, and moved objects usually land at other
objects' sites.  No oracle and no training: the sites come from the
agent's own map.
"""

from __future__ import annotations

from typing import Optional, Set

import numpy as np

from mass_tpu_torch import taxonomy
from mass_tpu_torch.config import MatchConfig
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.match.find import find_all_classes

# classes the matcher can act on: structure mass (OccupiedSpace, class 0)
# is walls and furniture, never a difference, so it spends no goal
_ACTIONABLE = np.asarray(
    [p or o for p, o in zip(taxonomy.ID_TO_PICKABLE,
                            taxonomy.ID_TO_OPENABLE)])
# the instance cap doubles on truncation up to this many per class
_MAX_INSTANCES = 256


def walkthrough_sites(vm0: VoxelMap, match: MatchConfig) -> np.ndarray:
    """``[N, 3]`` float32 world positions of every actionable-class
    instance in the walkthrough map, with the matcher's detection
    parameters; the instance cap doubles while an actionable class is
    truncated (up to 256), so dense scenes lose no site."""
    k = match.max_instances
    while True:
        inst = find_all_classes(
            vm0, confidence_threshold=match.confidence_threshold,
            contour_padding=match.contour_padding,
            contour_threshold=match.contour_threshold, max_instances=k)
        trunc = inst.truncated.cpu().numpy().astype(bool)
        if k >= _MAX_INSTANCES or not bool((trunc & _ACTIONABLE).any()):
            break
        k *= 2
    present = inst.present.cpu().numpy() & _ACTIONABLE[:, None]   # [C, K]
    pos = inst.position.cpu().numpy()                             # [C, K, 3]
    return pos[present].astype(np.float32)


def pick_site(sites: np.ndarray, used: Set[int],
              rng) -> Optional[np.ndarray]:
    """An unused site picked uniformly with one ``rng`` draw and marked
    used; None once every site has been visited (the caller falls back to
    the frontier goal)."""
    unused = [i for i in range(len(sites)) if i not in used]
    if not unused:
        return None
    i = unused[rng.randint(len(unused))]
    used.add(i)
    return sites[i]
