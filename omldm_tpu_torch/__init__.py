"""omldm_tpu_torch -- the PyTorch/CUDA port of omldm_tpu.

A second package beside ``omldm_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's layout and names module by module:

    - ``omldm_tpu_torch.api``           external JSON contract
    - ``omldm_tpu_torch.learners``      online learners (ported: PA)
    - ``omldm_tpu_torch.preprocessors`` streaming transforms (ported: StandardScaler)
    - ``omldm_tpu_torch.pipelines``     preprocessors + learner composition
    - ``omldm_tpu_torch.protocols``     distributed-learning protocols (ported: Asynchronous)
    - ``omldm_tpu_torch.runtime``       host-side stream runtime (spoke/hub/job)
    - ``omldm_tpu_torch.ops``           hand-written CUDA kernels (``csrc/``)
    - ``omldm_tpu_torch.utils``         shared helpers

Entry point: ``StreamJob(config, device=None).run(events)``; the device is
CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from omldm_tpu_torch.config import JobConfig  # noqa: F401
from omldm_tpu_torch.runtime import StreamJob  # noqa: F401
