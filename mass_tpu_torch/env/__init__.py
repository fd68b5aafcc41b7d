from mass_tpu_torch.env.protocol import (  # noqa: F401
    AgentPose, StepResult, Task)
