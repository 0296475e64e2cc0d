"""API stability annotations (port of ``flink_tpu/core/annotations.py``).

reference: flink-annotations (@Public, @PublicEvolving, @Internal,
@Experimental) with ArchUnit rules asserting every class reachable from the
public API surface carries a stability marker. Here the decorators stamp
``__api_stability__``; ``tests/test_torch_datastream_surface.py`` holds
the port's public surface to the reference's markers.
"""

from __future__ import annotations

PUBLIC = "public"
PUBLIC_EVOLVING = "public-evolving"
EXPERIMENTAL = "experimental"
INTERNAL = "internal"


def _stamp(level: str):
    def decorate(obj):
        obj.__api_stability__ = level
        return obj

    return decorate


#: stable API — breaking changes only at major versions
public = _stamp(PUBLIC)
#: public but may evolve between minor versions
public_evolving = _stamp(PUBLIC_EVOLVING)
#: may change or vanish at any time
experimental = _stamp(EXPERIMENTAL)
#: implementation detail, no compatibility promise
internal = _stamp(INTERNAL)


def stability_of(obj) -> str | None:
    return getattr(obj, "__api_stability__", None)
