"""omldm_tpu_torch -- the PyTorch/CUDA port of omldm_tpu.

A second package beside ``omldm_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's layout and names module by module:

    - ``omldm_tpu_torch.api``           external JSON contract
    - ``omldm_tpu_torch.learners``      online learners (all nine, and the
                                        sparse PA, RegressorPA, SVM, Softmax)
    - ``omldm_tpu_torch.preprocessors`` streaming transforms (StandardScaler,
                                        MinMaxScaler, PolynomialFeatures)
    - ``omldm_tpu_torch.pipelines``     preprocessors + learner composition
    - ``omldm_tpu_torch.protocols``     the host plane's eight protocols
    - ``omldm_tpu_torch.parallel``      the SPMD engine (``SPMDTrainer``, its
                                        mesh) and the sequence-model trainer
    - ``omldm_tpu_torch.runtime``       stream runtime: spokes, hubs, the job,
                                        the SPMD bridges, ingest, serving,
                                        supervised recovery, the multi-process
                                        fleet and its supervisor
    - ``omldm_tpu_torch.checkpoint``    job snapshots, rescale-merge restore
    - ``omldm_tpu_torch.models``        the transformer LM
    - ``omldm_tpu_torch.ops``           hand-written CUDA kernels (``csrc/``),
                                        the native parser (``ops/native``)
    - ``omldm_tpu_torch.utils``         shared helpers

Entry points: ``StreamJob(config, device=None).run(events)`` and ``python
-m omldm_tpu_torch``; the device is CUDA unless the caller passes
``device="cpu"`` (``--device cpu``).
"""

__version__ = "0.1.0"

from omldm_tpu_torch.config import JobConfig  # noqa: F401
from omldm_tpu_torch.runtime import StreamJob  # noqa: F401
