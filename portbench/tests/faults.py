"""Faults planted in the timed path, underneath the harness, for the
tests that see ``correct`` come out false: maps left unchanged, half of
the batch left out, a plan's target altered where it is produced, a
frame's classes altered where the sensor produces them, a dense voxel
altered where the dense update writes it, one weight of the backbone
perturbed where it is loaded.  One card: there is no exchange between
chips to leave out."""

import numpy as np
import torch

FAULTS = ("state_unchanged", "half_batch_left_out", "answer_altered",
          "class_altered", "dense_voxel_altered", "backbone_weight_perturbed")


def plant(name, monkeypatch) -> None:
    from mass_tpu_torch.nav import grid as NG
    from mass_tpu_torch.parallel.fleet import FleetMaps
    from mass_tpu_torch.perception import resnet, segmentation

    update, to_host = FleetMaps.update_batch, NG.plan_to_host
    dense, load = FleetMaps.update_dense, resnet.from_state_dict
    if name == "state_unchanged":
        monkeypatch.setattr(FleetMaps, "update_batch",
                            lambda self, *a, **k: None)
    elif name == "half_batch_left_out":
        def half(self, *a, active=None, **k):
            keep = np.arange(self.batch) < self.batch // 2
            return update(self, *a, active={n: m & keep
                                            for n, m in active.items()}, **k)
        monkeypatch.setattr(FleetMaps, "update_batch", half)
    elif name == "answer_altered":
        def altered(*a):
            dist, tgt, agent, er, ed = to_host(*a)
            tgt[0, 0] += 1
            return dist, tgt, agent, er, ed
        monkeypatch.setattr(NG, "plan_to_host", altered)
    elif name == "class_altered":
        make = segmentation.make_batched_sensor

        def altered_sensor(sensor):
            batched = make(sensor)

            def run_(rgb):
                # the first frame's answer altered: every pixel one class on
                out = batched(rgb)
                out[0] = (out[0] + 1) % 54
                return out
            return run_
        monkeypatch.setattr(segmentation, "make_batched_sensor",
                            altered_sensor)
    elif name == "dense_voxel_altered":
        def altered_dense(self, *a, **k):
            dense(self, *a, **k)
            # one channel of the first dense family's first voxel
            self.buffers[self.dense_names[0]][0, 0] += 1.0
        monkeypatch.setattr(FleetMaps, "update_dense", altered_dense)
    elif name == "backbone_weight_perturbed":
        def perturbed(*a, **k):
            module = load(*a, **k)
            with torch.no_grad():
                module.conv1.weight[0, 0, 3, 3] += 0.05
            return module
        monkeypatch.setattr(resnet, "from_state_dict", perturbed)
    else:
        raise KeyError(name)
