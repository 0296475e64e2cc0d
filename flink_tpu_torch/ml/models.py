"""Model abstractions for ML_PREDICT (port of ``flink_tpu/ml/models.py``;
see the flink_tpu_torch.ml package docstring).

reference: flink-models/* providers + the model catalog objects behind
``CREATE MODEL`` (flink-table: CatalogModel with provider options).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from flink_tpu_torch.ops.segment_ops import sticky_bucket


from flink_tpu_torch.core.annotations import public_evolving

@public_evolving
class Model:
    """A batched inference function: column arrays in, column arrays out.

    ``input_names``/``output_names`` are the declared schema (the
    reference's CatalogModel input/output schema)."""

    input_names: Sequence[str] = ()
    output_names: Sequence[str] = ()

    def predict(self, inputs: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass


@public_evolving
class FunctionModel(Model):
    """Vectorized Python/NumPy callable as a model."""

    def __init__(self, fn: Callable[[Dict[str, np.ndarray]],
                                    Dict[str, np.ndarray]],
                 input_names: Sequence[str],
                 output_names: Sequence[str]):
        self.fn = fn
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names)

    def predict(self, inputs):
        return self.fn(inputs)


@public_evolving
class TorchModel(Model):
    """A torch module as a model — inference runs on the same device as
    the pipeline's keyed state, one forward pass per micro-batch (the
    reference's ``JaxModel``, whose ``apply_fn(params, *inputs)`` is here
    ``module(*inputs)``).

    ``module(*inputs) -> output | tuple`` runs under
    ``torch.inference_mode()`` on ``device`` (default:
    ``execution.device``, the card); floating inputs are cast to the
    module's parameter dtype, and batches pad to sticky buckets so that
    varying micro-batch sizes keep one set of shapes.
    """

    def __init__(self, module, input_names: Sequence[str],
                 output_names: Sequence[str], device=None):
        import torch

        from flink_tpu_torch.core.device import resolve_device

        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names)
        params = [p for p in module.parameters() if p.is_floating_point()]
        self._float_dtype = params[0].dtype if params else torch.float32
        self._bucket = 0

    def predict(self, inputs):
        import torch

        n = len(next(iter(inputs.values())))
        size = sticky_bucket(n, self._bucket)
        self._bucket = size
        padded = []
        for name in self.input_names:
            v = np.asarray(inputs[name])
            pad = np.zeros((size - n,) + v.shape[1:], dtype=v.dtype)
            t = torch.from_numpy(np.ascontiguousarray(
                np.concatenate([v, pad]) if size > n else v))
            if t.is_floating_point():
                t = t.to(self._float_dtype)
            padded.append(t.to(self.device, non_blocking=True))
        with torch.inference_mode():
            out = self.module(*padded)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return {name: col.cpu().numpy()[:n]
                for name, col in zip(self.output_names, out)}


@public_evolving
class RemoteModel(Model):
    """External inference endpoint (the reference's OpenAI/Triton client
    role). The transport is injected: ``client(inputs) -> outputs`` —
    typically an HTTP call per micro-batch. Pair with
    AsyncMLPredictOperator for bounded-in-flight overlap (reference:
    AsyncMLPredictRunner)."""

    def __init__(self, client: Callable[[Dict[str, np.ndarray]],
                                        Dict[str, np.ndarray]],
                 input_names: Sequence[str],
                 output_names: Sequence[str],
                 open_fn: Optional[Callable[[], None]] = None,
                 close_fn: Optional[Callable[[], None]] = None):
        self.client = client
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names)
        self._open_fn = open_fn
        self._close_fn = close_fn

    def open(self):
        if self._open_fn:
            self._open_fn()

    def close(self):
        if self._close_fn:
            self._close_fn()

    def predict(self, inputs):
        return self.client(inputs)


@public_evolving
class ModelRegistry:
    """Model catalog (the reference's CatalogModel store behind CREATE
    MODEL / model identifiers in ML_PREDICT)."""

    def __init__(self):
        self._models: Dict[str, Model] = {}

    def register(self, name: str, model: Model) -> None:
        self._models[name] = model

    def get(self, name: str) -> Model:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._models)} (register with "
                "t_env.create_temporary_model or CREATE MODEL)") from None

    def create_from_options(self, name: str,
                            options: Dict[str, str]) -> None:
        """CREATE MODEL ... WITH (...) — the 'provider' option selects the
        factory (reference: model provider discovery). Built-in provider
        'python' imports ``entry`` = "module:attribute" resolving to a
        Model or a zero-arg factory."""
        provider = options.get("provider")
        if provider != "python":
            raise ValueError(
                f"unknown model provider {provider!r} (built-in: 'python'; "
                "remote providers are injected as RemoteModel instances)")
        entry = options.get("entry", "")
        mod_name, _, attr = entry.partition(":")
        if not mod_name or not attr:
            raise ValueError(
                "provider 'python' needs entry='module:attribute'")
        import importlib

        obj = getattr(importlib.import_module(mod_name), attr)
        model = obj() if callable(obj) and not isinstance(obj, Model) \
            else obj
        if not isinstance(model, Model):
            raise TypeError(f"{entry} did not resolve to a Model")
        self.register(name, model)
