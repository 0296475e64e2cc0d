"""``execution.checkpointing.retained``, the reference's legacy retention
key, against the reference (``flink_tpu/core/config.py``
``retained_checkpoints``): ``state.checkpoints.num-retained`` wins when
set, else the legacy key holds. Both executors (the single-slot loop and
the stage executor) keep the same checkpoint directories on disk as the
reference's on the same job. Tolerance: none (directory counts and
rows compared exactly).
"""

import os
import time

import pytest

import flink_tpu
import flink_tpu_torch

PKGS = {"ref": flink_tpu, "port": flink_tpu_torch}


def _paced(batch):
    time.sleep(0.03)
    return batch


def _run(pkg, ckpt_dir, extra):
    top = PKGS[pkg]
    conf = {"execution.micro-batch.size": 500,
            "state.checkpoints.dir": ckpt_dir,
            "execution.checkpointing.every-n-source-batches": 1,
            # the sources polled inline: one checkpoint per batch in
            # both packages
            "execution.pipeline.in-flight-batches": 0,
            **extra}
    if pkg == "port":
        conf["execution.device"] = "cpu"
    env = top.StreamExecutionEnvironment(top.Configuration(conf))
    src = __import__(f"{top.__name__}.connectors.sources",
                     fromlist=["x"]).DataGenSource(
        total_records=6_000, num_keys=50,
        events_per_second_of_eventtime=10_000, seed=3)
    wm = __import__(f"{top.__name__}.runtime.watermarks",
                    fromlist=["x"]).WatermarkStrategy \
        .for_bounded_out_of_orderness(0)
    asg = __import__(f"{top.__name__}.windowing.assigners",
                     fromlist=["x"])
    sink = __import__(f"{top.__name__}.connectors.sinks",
                      fromlist=["x"]).CollectSink()
    # a paced source: the stage executor's trigger loop polls the batch
    # count, and the reference's cannot keep up with an unpaced one
    env.from_source(src, wm).map(_paced, name="paced").key_by("key").window(
        asg.TumblingEventTimeWindows.of(200)).count().sink_to(sink)
    env.execute("retained")
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("chk-")), \
        sorted(tuple(sorted(r.items())) for r in sink.rows())


@pytest.mark.parametrize("stage", [0, 2], ids=["single-slot", "stage"])
@pytest.mark.parametrize("extra,kept", [
    ({"execution.checkpointing.retained": 5}, 5),
    ({"execution.checkpointing.retained": 5,
      "state.checkpoints.num-retained": 2}, 2),
], ids=["legacy-key-holds", "num-retained-wins"])
def test_retained_checkpoints_match_the_reference(tmp_path, stage, extra,
                                                  kept):
    extra = dict(extra)
    if stage:
        extra["execution.stage-parallelism"] = stage
    got = {pkg: _run(pkg, str(tmp_path / pkg), extra) for pkg in PKGS}
    assert got["port"][1] == got["ref"][1]
    if not stage:
        # the single-slot loop checkpoints exactly once a batch
        assert got["port"][0] == got["ref"][0]
    assert len(got["port"][0]) == len(got["ref"][0]) == kept
