"""dmlc_core_tpu_torch — the PyTorch/CUDA port of ``dmlc_core_tpu``.

Runs on an NVIDIA H100 (Hopper, ``sm_90a``) with kernels written by hand
in CUDA C++ where the JAX package had Pallas kernels.  Its layout mirrors
the JAX package (``data/``, ``pipeline/``, ``ops/``, ``models/``,
``serving/``, ``transport/``, ``telemetry/``, ``utils/``, ``io/``, plus
``kernels/``), and each module names its JAX counterpart.  It imports
``torch`` and ``numpy`` and nothing of JAX or of ``dmlc_core_tpu``.

Entry points run on ``cuda`` unless given ``device="cpu"``; on the CPU
every op runs its kernel's plain PyTorch version.

It trains logistic regression, the factorization machine, the
field-aware FM, DeepFM and DCNv2 on libsvm, libfm or csv text::

    from dmlc_core_tpu_torch import (DeepFM, DeviceLoader, adam,
                                     create_parser, fit_stream)
    model = DeepFM(num_features=1 << 20, dim=32, layers=2)
    loader = DeviceLoader(create_parser("train.libsvm"), batch_rows=4096,
                          nnz_cap=64, layout="rowmajor")
    fit_stream(model, loader, optimizer=adam(model, 1e-3))

the field-aware FM on libfm text, its fields beside the ids::

    model = FieldAwareFM(num_features=1 << 18, num_fields=40, dim=4)
    loader = DeviceLoader(create_parser("train.libfm", parser_type="libfm"),
                          batch_rows=4096, nnz_cap=131072, fields=True)
    fit_stream(model, loader, optimizer=adam(model, 1e-3))

k steps a dispatch, each dispatch one replay of a captured CUDA graph::

    loader = DeviceLoader(create_parser("train.libsvm"), batch_rows=4096,
                          nnz_cap=131072, emit="host")
    fit_stream(model, loader, optimizer=adam(model, 1e-3), kstep=8)

data-parallel over W processes, one card each (torchrun, or the
reference's ``DMLC_TASK_ID``/``DMLC_NUM_WORKER`` with ``MASTER_ADDR`` and
``MASTER_PORT``), each rank reading its partition::

    from dmlc_core_tpu_torch.models import batch_sharding
    from dmlc_core_tpu_torch.parallel import make_mesh
    mesh = make_mesh("dp=-1")
    loader = DeviceLoader(create_parser("train.libsvm", mesh.rank,
                                        mesh.world),
                          batch_rows=4096, nnz_cap=131072,
                          sharding=batch_sharding(mesh))
    fit_stream(model, loader, optimizer=adam(model, 1e-3), mesh=mesh)

or from the command line, as the JAX package's ``dmlc-train``::

    python -m dmlc_core_tpu_torch.models.cli model=deepfm data=train.libsvm

and serves the factorization machine::

    from dmlc_core_tpu_torch import InferenceEngine, MicroBatcher
    model = FactorizationMachine(num_features=1 << 20, dim=32)
    engine = InferenceEngine(model, postprocess="sigmoid", warmup=True)
    with MicroBatcher(engine) as batcher:
        scores = batcher.submit(ids, vals, row_ptr).result()

over TCP, on the JAX package's wire (each bucket one captured CUDA
graph)::

    with PredictionServer(engine, port=9200).start():
        with PredictClient("127.0.0.1", 9200) as client:
            scores = client.predict(ids, vals, row_ptr)

or from the command line::

    python -m dmlc_core_tpu_torch.serving.server ckpt_dir=ck features=1048576 model=fm dim=32 port=9200
    python -m dmlc_core_tpu_torch.serving.client 127.0.0.1:9200 requests=2000 concurrency=8
"""

from . import (data, io, kernels, models, ops, parallel,  # noqa: F401
               pipeline, serving, telemetry, transport, utils)
from .data import create_parser  # noqa: F401
from .models import (FTRL, Adam, DCNv2, DeepFM,  # noqa: F401
                     FactorizationMachine, FieldAwareFM, FusedTrainer,
                     SparseLogReg, adam,
                     evaluate_stream, fit_stream, make_train_step,
                     params_from_jax, params_to_numpy)
from .pipeline import DeviceLoader  # noqa: F401
from .serving import (BucketLadder, InferenceEngine,  # noqa: F401
                      MicroBatcher, PredictClient, PredictionServer,
                      run_load)
from .utils import CheckpointManager, DMLCError  # noqa: F401

__version__ = "0.1.0"

__all__ = ["FactorizationMachine", "FieldAwareFM", "SparseLogReg", "DCNv2",
           "DeepFM",
           "params_from_jax", "params_to_numpy", "create_parser",
           "DeviceLoader", "make_train_step", "fit_stream", "evaluate_stream",
           "adam", "Adam", "FTRL", "FusedTrainer", "InferenceEngine",
           "BucketLadder", "MicroBatcher", "PredictionServer",
           "PredictClient", "run_load", "CheckpointManager", "DMLCError"]
