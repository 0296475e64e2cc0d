"""ML_PREDICT operators (port of ``flink_tpu/ml/operators.py``).

reference: flink-table-runtime/.../operators/ml/MLPredictRunner.java (sync)
and AsyncMLPredictRunner.java (bounded in-flight async) — but batched: one
``Model.predict`` call per micro-batch instead of one request per record.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.ml.models import Model
from flink_tpu_torch.runtime.operators import Operator


class MLPredictOperator(Operator):
    """Synchronous batched inference: appends the model's output columns
    to each batch (reference: MLPredictRunner, minus the per-record RPC)."""

    name = "ml_predict"

    def __init__(self, model: Model,
                 input_fields: Optional[Sequence[str]] = None,
                 output_prefix: str = ""):
        self.model = model
        self.input_fields = tuple(input_fields or model.input_names)
        if len(self.input_fields) != len(model.input_names):
            raise ValueError(
                f"model expects {len(model.input_names)} inputs "
                f"{tuple(model.input_names)}, got descriptor "
                f"{self.input_fields}")
        self.output_prefix = output_prefix

    def open(self, ctx):
        self.model.open()

    def process_batch(self, batch: RecordBatch, input_index: int = 0):
        if len(batch) == 0:
            # dropped, not forwarded: an empty batch without the promised
            # output columns would break downstream projections
            return []
        inputs = {
            name: np.asarray(batch[field])
            for name, field in zip(self.model.input_names,
                                   self.input_fields)
        }
        outputs = self.model.predict(inputs)
        for name in self.model.output_names:
            batch = batch.with_column(self.output_prefix + name,
                                      outputs[name])
        return [batch]

    def close(self):
        self.model.close()
        return []


class AsyncMLPredictOperator(Operator):
    """Async variant: inference overlaps with upstream processing under a
    bounded in-flight budget, results re-emitted in order (reference:
    AsyncMLPredictRunner over the async wait operator)."""

    name = "async_ml_predict"

    def __init__(self, model: Model,
                 input_fields: Optional[Sequence[str]] = None,
                 output_prefix: str = "", capacity: int = 4,
                 timeout_s: float = 30.0):
        from flink_tpu_torch.runtime.async_operator import (
            AsyncFunction,
            AsyncWaitOperator,
        )

        predictor = MLPredictOperator(model, input_fields, output_prefix)

        class _Predict(AsyncFunction):
            def open(self):
                model.open()

            def close(self):
                model.close()

            def invoke(self, batch):
                return predictor.process_batch(batch)[0]

        self._inner = AsyncWaitOperator(_Predict(), ordered=True,
                                        capacity=capacity,
                                        timeout_ms=int(timeout_s * 1000))

    def open(self, ctx):
        self._inner.open(ctx)

    def process_batch(self, batch, input_index=0):
        return self._inner.process_batch(batch, input_index)

    def process_watermark(self, watermark, input_index=0):
        return self._inner.process_watermark(watermark, input_index)

    def close(self):
        return self._inner.close()

    def dispose(self):
        self._inner.dispose()

    # in-flight batches must ride checkpoints for exactly-once replay
    # (reference: AsyncWaitOperator state snapshot of pending elements)
    def snapshot_state(self):
        return self._inner.snapshot_state()

    def restore_state(self, state):
        self._inner.restore_state(state)
