"""CEP — complex event processing (pattern matching on keyed streams),
port of ``flink_tpu/cep/``: the pattern API and the host NFA
(``CEP.pattern(keyed, p).select()`` plans the host ``CepOperator``, as
in the reference), and the device NFA engine on the logical mesh
(``MeshCepEngine``, ``MeshCepOperator``) for the bounded-partial pattern
class.

reference: flink-libraries/flink-cep (NFA-based pattern matching on keyed
state + timers).
"""

from flink_tpu_torch.cep.nfa import KeyNFA, Match
from flink_tpu_torch.cep.operator import CEP, CepOperator, PatternStream
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern

__all__ = ["AfterMatchSkipStrategy", "CEP", "CepOperator", "KeyNFA",
           "Match", "MeshCepEngine", "MeshCepOperator", "Pattern",
           "PatternStream", "UnsupportedCepPattern",
           "compile_device_pattern"]


def __getattr__(name):
    # the device engine pulls in torch + the state-plane stack; keep the
    # host-only CEP API importable without that weight
    if name in ("MeshCepEngine", "record_host_fallback", "host_fallbacks"):
        from flink_tpu_torch.cep import mesh_engine

        return getattr(mesh_engine, name)
    if name in ("UnsupportedCepPattern", "compile_device_pattern",
                "DevicePatternLayout"):
        from flink_tpu_torch.cep import kernels

        return getattr(kernels, name)
    if name == "MeshCepOperator":
        from flink_tpu_torch.cep.operators import MeshCepOperator

        return MeshCepOperator
    raise AttributeError(name)
