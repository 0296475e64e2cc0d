"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's window operator for one run on the
CPU (the harness's look for a card is skipped): a step that leaves the
state unchanged, half of each batch left out, and an answer altered where
it is produced. The cells run on one card, so there is no exchange between
chips to leave out.
"""

from __future__ import annotations

import pytest

from streambench import run
from streambench.tests.test_streambench_harness import SEED, tiny


def _unchanged(orig):
    def process_batch(self, batch, input_index=0):
        return []
    return process_batch


def _half(orig):
    def process_batch(self, batch, input_index=0):
        return orig(self, batch.slice(0, len(batch) // 2), input_index)
    return process_batch


def _altered(orig):
    def reattach(self, batch):
        out = orig(self, batch)
        v = out.columns["count"].copy()
        v[0] = v[0] + 1
        out.columns["count"] = v
        return out
    return reattach


FAULTS = {"unchanged": ("process_batch", _unchanged),
          "half_batch": ("process_batch", _half),
          "altered": ("_reattach_keys", _altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["q5_p8_sat"])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    from flink_tpu_torch.runtime.operators import WindowAggOperator

    attr, make = FAULTS[fault]
    monkeypatch.setattr(WindowAggOperator, attr,
                        make(getattr(WindowAggOperator, attr)))
    out = run.run(tiny(name), SEED, 0.5, False, device="cpu")
    assert out["correct"] is False and out["failed"] > 0
