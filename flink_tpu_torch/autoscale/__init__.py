"""Autoscaler (port of ``flink_tpu/autoscale/``): elastic rescaling and
skew response of the keyed plane.

``policy`` decides *how many* logical shards a keyed operator should
have, ``controller`` how to get there (the engines' live ``reshard``, or
the MiniCluster's cold redeploy), and ``rebalance`` handles skew: it
moves hot key groups between shards (``engine.reassign_key_groups``) and
splits single dominant keys (``engine.register_hot_key``).
"""

from flink_tpu_torch.autoscale.policy import (  # noqa: F401
    Decision,
    PolicyInput,
    ScalingPolicy,
)
from flink_tpu_torch.autoscale.controller import (  # noqa: F401
    AutoscaleController,
    RescaleEvent,
)
from flink_tpu_torch.autoscale.rebalance import (  # noqa: F401
    RebalancePlan,
    RebalancePolicy,
    SkewResponder,
)
