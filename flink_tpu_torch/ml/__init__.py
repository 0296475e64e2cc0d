"""ML model functions — batched inference inside the pipeline
(port of ``flink_tpu/ml/__init__.py``).

reference: flink-models (flink-model-openai chat/embedding client,
flink-model-triton REST client) invoked from SQL ``ML_PREDICT`` via
flink-table-runtime/.../operators/ml/MLPredictRunner.java (sync, one
record per request) and AsyncMLPredictRunner.java (async, bounded
in-flight), with models declared by ``CREATE MODEL`` DDL.

Re-design: a model is a *batched vectorized function*, and the natural
provider is a torch module on the same device as the keyed state — one
forward pass per micro-batch instead of one request per record:

- :class:`TorchModel` — an ``nn.Module`` under ``torch.inference_mode()``
  on its device (``execution.device`` by default), with sticky padding
  buckets so that varying micro-batch sizes keep one set of shapes.
- :class:`FunctionModel` — any vectorized NumPy/Python callable.
- :class:`RemoteModel` — an external-endpoint client (the reference's
  OpenAI/Triton role); its transport is injected, and the async operator
  bounds its in-flight calls like AsyncMLPredictRunner.
"""

from flink_tpu_torch.ml.models import (
    FunctionModel,
    Model,
    ModelRegistry,
    RemoteModel,
    TorchModel,
)
from flink_tpu_torch.ml.operators import AsyncMLPredictOperator, MLPredictOperator

__all__ = [
    "Model",
    "FunctionModel",
    "RemoteModel",
    "TorchModel",
    "ModelRegistry",
    "MLPredictOperator",
    "AsyncMLPredictOperator",
]
