"""ML_PREDICT, models and the ML operators of the port against the
reference, on the CPU.

The cases are those of ``tests/test_ml_predict.py``, each run through both
packages with the same rows; rows compare bit for bit in order wherever
the model is the same NumPy function in both. The reference's
``JaxModel`` becomes the port's ``TorchModel``: the same two-layer MLP
(width 64, float32, weights from a seed) goes through ``jax.jit`` in the
reference and through an ``nn.Module`` in the port, its parameters carried
by ``convert.from_jax_model_params``. The two differ only in how their
float32 matmuls associate, so their predictions are held to
``rtol=1e-5, atol=1e-5``, and the window sums over them to ``rtol=1e-5``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sql import PKGS, assert_batches_equal

#: TorchModel vs JaxModel, float32 MLP of width 64 on the CPU
RTOL, ATOL = 1e-5, 1e-5


def _doubler(p):
    return p.mod("ml.models").FunctionModel(
        lambda ins: {"doubled": ins["x"] * 2},
        input_names=["x"], output_names=["doubled"])


def doubler_model_reference():
    """CREATE MODEL's 'python' provider entry for the reference."""
    return _doubler(PKGS["reference"])


def doubler_model_port():
    """CREATE MODEL's 'python' provider entry for the port."""
    return _doubler(PKGS["port"])


def _rows(n=20):
    return [{"price": float(i), "qty": i % 5, "ts": i * 100}
            for i in range(n)]


def _tenv(p, **conf):
    return p.tenv({"execution.micro-batch.size": 7, **conf})


# ------------------------------------------------------------- the MLP


def _mlp_params(seed=0, d_in=4, width=64):
    rng = np.random.default_rng(seed)
    return {"l0": {"w": (rng.normal(size=(d_in, width)) / 2).astype(
                np.float32),
                   "b": rng.normal(size=width).astype(np.float32)},
            "l1": {"w": (rng.normal(size=(width, 1)) / 8).astype(np.float32),
                   "b": rng.normal(size=1).astype(np.float32)}}


def _jax_model(params):
    import jax
    import jax.numpy as jnp

    from flink_tpu.ml import JaxModel

    def apply(p, x):
        h = jax.nn.relu(x @ p["l0"]["w"] + p["l0"]["b"])
        return (h @ p["l1"]["w"] + p["l1"]["b"])[:, 0]

    return JaxModel(apply, jax.tree_util.tree_map(jnp.asarray, params),
                    input_names=["x"], output_names=["y"])


class _MLP(torch.nn.Module):
    def __init__(self, d_in=4, width=64):
        super().__init__()
        self.l0 = torch.nn.Linear(d_in, width)
        self.l1 = torch.nn.Linear(width, 1)

    def forward(self, x):
        return self.l1(torch.relu(self.l0(x)))[:, 0]


def _torch_model(params, device="cpu"):
    from flink_tpu_torch.convert import from_jax_model_params
    from flink_tpu_torch.ml import TorchModel

    t = from_jax_model_params(params, device="cpu")
    module = _MLP()
    module.load_state_dict({
        "l0.weight": t["l0.w"].T, "l0.bias": t["l0.b"],
        "l1.weight": t["l1.w"].T, "l1.bias": t["l1.b"]})
    return TorchModel(module, ["x"], ["y"], device=device)


def test_from_jax_model_params_flattens_the_pytree():
    from flink_tpu_torch.convert import from_jax_model_params

    params = _mlp_params()
    params["extra"] = [np.arange(3, dtype=np.int64)]
    t = from_jax_model_params(params, device="cpu")
    assert sorted(t) == ["extra.0", "l0.b", "l0.w", "l1.b", "l1.w"]
    np.testing.assert_array_equal(t["l0.w"].numpy(), params["l0"]["w"])
    assert t["extra.0"].dtype == torch.int64


def test_torch_model_equals_jax_model_on_the_same_mlp():
    params = _mlp_params()
    jm, tm = _jax_model(params), _torch_model(params)
    rng = np.random.default_rng(1)
    buckets = []
    for n in (5, 9, 6, 300, 17):          # varying sizes, sticky buckets
        x = rng.normal(size=(n, 4)).astype(np.float32)
        got, want = tm.predict({"x": x})["y"], jm.predict({"x": x})["y"]
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        buckets.append((tm._bucket, jm._bucket))
    assert [a for a, _ in buckets] == [b for _, b in buckets]


def test_torch_model_casts_float64_inputs_to_its_parameters():
    params = _mlp_params()
    x = np.random.default_rng(2).normal(size=(8, 4))
    got = _torch_model(params).predict({"x": x})["y"]
    want = _torch_model(params).predict({"x": x.astype(np.float32)})["y"]
    np.testing.assert_array_equal(got, want)


def test_torch_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from flink_tpu_torch.ml import TorchModel

    with pytest.raises(RuntimeError, match="execution.device"):
        TorchModel(_MLP(), ["x"], ["y"])


# ------------------------------------------------------------ operators


def test_operator_appends_outputs():
    out = {}
    for name, p in PKGS.items():
        op = p.mod("ml.operators").MLPredictOperator(
            _doubler(p), input_fields=["price"])
        op.open(p.mod("runtime.operators").OperatorContext())
        out[name] = op.process_batch(p.RecordBatch.from_pydict(
            {"price": np.arange(4, dtype=np.float32)}))[0]
    assert_batches_equal(out["port"], out["reference"])
    assert list(out["port"].columns) == ["price", "doubled"]


def test_descriptor_arity_checked_as_the_reference():
    msgs = {}
    for name, p in PKGS.items():
        with pytest.raises(ValueError, match="expects 1 inputs") as e:
            p.mod("ml.operators").MLPredictOperator(
                _doubler(p), input_fields=["a", "b"])
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


def _pipeline(p, model, rows, asynchronous, batch_size=7, capacity=4):
    env = p.Env(p.config(**{"execution.micro-batch.size": batch_size}))
    sink = p.CollectSink()
    src = p.mod("connectors.sources").CollectionSource.of_rows(
        rows, batch_size=batch_size)
    wm = p.mod("runtime.watermarks").WatermarkStrategy
    strategy = wm.for_monotonous_timestamps()
    if "ts" in rows[0]:
        strategy = strategy.with_timestamp_field("ts")
    env.from_source(src, strategy).ml_predict(
        model, input_fields=["price"], asynchronous=asynchronous,
        capacity=capacity).sink_to(sink)
    env.execute("ml")
    return sink.result()


@pytest.mark.parametrize("asynchronous", [False, True])
def test_ml_predict_in_pipeline(asynchronous):
    out = {name: _pipeline(p, _doubler(p), _rows(), asynchronous)
           for name, p in PKGS.items()}
    assert_batches_equal(out["port"], out["reference"])
    assert len(out["port"]) == 20
    assert (out["port"]["doubled"] == out["port"]["price"] * 2).all()


def test_remote_model_async_bounded():
    import time

    out = {}
    for name, p in PKGS.items():
        calls = []

        def client(inputs, calls=calls):
            calls.append(len(inputs["x"]))
            time.sleep(0.005)
            return {"score": inputs["x"] + 1}

        model = p.mod("ml.models").RemoteModel(
            client, input_names=["x"], output_names=["score"])
        out[name] = _pipeline(p, model, [{"price": float(i)}
                                         for i in range(30)],
                              True, batch_size=5, capacity=3)
        assert sum(calls) == 30
    assert_batches_equal(out["port"], out["reference"])
    assert out["port"]["score"].tolist() == [float(i) + 1 for i in range(30)]


# ------------------------------------------------------------------ SQL


def _sql_both(sql, register, **conf):
    out = {}
    for name, p in PKGS.items():
        tenv = _tenv(p, **conf)
        tenv.create_temporary_view("orders", tenv.from_collection(
            _rows(), timestamp_field="ts"))
        register(name, p, tenv)
        out[name] = tenv.execute_sql(sql).to_batch()
    assert_batches_equal(out["port"], out["reference"])
    return out["port"]


def _register_doubler(name, p, tenv):
    tenv.create_temporary_model("scorer", _doubler(p))


def test_ml_predict_tvf():
    out = _sql_both(
        "SELECT price, doubled FROM ML_PREDICT(TABLE orders, MODEL scorer, "
        "DESCRIPTOR(price)) WHERE doubled > 10", _register_doubler)
    assert len(out) == 14


def test_ml_predict_feeds_aggregate():
    out = _sql_both(
        "SELECT qty, SUM(doubled) AS s FROM ML_PREDICT(TABLE orders, MODEL "
        "scorer, DESCRIPTOR(price)) GROUP BY qty", _register_doubler)
    want = {}
    for r in _rows():
        want[r["qty"]] = want.get(r["qty"], 0.0) + r["price"] * 2
    assert dict(zip(out["qty"].tolist(), out["s"].tolist())) == want


def test_create_model_ddl():
    def register(name, p, tenv):
        tenv.execute_sql(
            "CREATE MODEL scorer WITH ('provider' = 'python', 'entry' = "
            f"'tests.test_torch_ml_predict:doubler_model_{name}')")

    out = _sql_both("SELECT doubled FROM ML_PREDICT(TABLE orders, MODEL "
                    "scorer, DESCRIPTOR(price))", register)
    assert len(out) == 20


def test_unknown_model_and_provider_errors_as_the_reference():
    msgs = {}
    for name, p in PKGS.items():
        tenv = _tenv(p)
        tenv.create_temporary_view("orders", tenv.from_collection(
            _rows(), timestamp_field="ts"))
        with pytest.raises(KeyError, match="unknown model 'nope'") as e1:
            tenv.execute_sql("SELECT * FROM ML_PREDICT(TABLE orders, MODEL "
                             "nope, DESCRIPTOR(price))")
        with pytest.raises(ValueError, match="unknown model provider") as e2:
            tenv.execute_sql("CREATE MODEL m WITH ('provider' = 'openai')")
        msgs[name] = (str(e1.value), str(e2.value))
    assert msgs["port"] == msgs["reference"]


def test_sql_mlp_feeds_a_tumbling_sum():
    """Phase 21(d)'s shape at a cut size: ML_PREDICT with the MLP (a
    JaxModel in the reference, a TorchModel in the port) feeding
    TUMBLE(1 s) SUM(y) GROUP BY k over 20k records: the same windows, and
    sums within float32 tolerance."""
    rng = np.random.default_rng(3)
    n = 20_000
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    rows = {"k": rng.integers(0, 10, n).astype(np.int64),
            "ts": np.arange(n, dtype=np.int64)}
    params = _mlp_params()
    out = {}
    for name, p in PKGS.items():
        tenv = p.tenv({"execution.micro-batch.size": 4096})
        batches = [p.RecordBatch.from_pydict(
            {"k": rows["k"][i:i + 4096], "ts": rows["ts"][i:i + 4096],
             "x": feats[i:i + 4096]},
            timestamps=rows["ts"][i:i + 4096]) for i in range(0, n, 4096)]
        env = tenv.env
        src = p.mod("connectors.sources").CollectionSource(batches)
        wm = p.mod("runtime.watermarks").WatermarkStrategy
        tenv.create_temporary_view(
            "feats", env.from_source(src,
                                     wm.for_bounded_out_of_orderness(0)),
            columns=["k", "ts", "x"], time_field="ts")
        tenv.create_temporary_model(
            "mlp", _jax_model(params) if name == "reference"
            else _torch_model(params))
        tenv.execute_sql(
            "CREATE VIEW scored AS SELECT k, ts, y FROM ML_PREDICT(TABLE "
            "feats, MODEL mlp, DESCRIPTOR(x))")
        out[name] = tenv.execute_sql(
            "SELECT k, window_end, SUM(y) AS s FROM TABLE(TUMBLE(TABLE "
            "scored, DESCRIPTOR(ts), INTERVAL '1' SECOND)) GROUP BY k, "
            "window_start, window_end").to_batch()
    got, want = out["port"], out["reference"]
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_array_equal(got["window_end"], want["window_end"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-5, atol=1e-4)
    assert len(got) == 10 * 20
