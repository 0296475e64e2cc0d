"""Fire: host wall covered by the union of the ``op.watermark`` and
``fire.harvest`` spans (nested ones counted once), per million events."""

from streambench.stats import union_s

KINDS = ("op.watermark", "fire.harvest")


def read(run):
    if run.spans is None or not run.events:
        return None
    w0, w1 = run.window
    iv = [(max(s.t0, w0), min(s.t1, w1)) for s in run.spans
          if s.kind in KINDS and not s.instant]
    if not iv:
        return None
    return union_s(iv) / (run.events / 1e6)
