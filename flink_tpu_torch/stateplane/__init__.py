"""The port's state-plane programs: the exchange-rank family
(``flink_tpu_torch.stateplane.rank``) and the stream-ordered float fold
(``flink_tpu_torch.stateplane.fold``)."""
