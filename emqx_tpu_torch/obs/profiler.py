"""The stage-mark seam of the delivery-path profiler (the port's own
copy of `STAGE_MARK` from emqx_tpu/obs/profiler.py; the sampling
profiler that reads it comes with the broker slice).

The Router stamps `STAGE_MARK.stage` with the sub-stage it is entering
(`encode`, `launch`, `ticket_start`); a sampler reads it to bucket each
stack under the sub-stage that was live when the sample hit. The
hot-path cost is one attribute store per stage transition.
"""

from __future__ import annotations


class _StageMark:
    """The one-cell stage register the delivery path stamps and the
    sampler reads. A plain attribute store/read — no locks: a torn
    read can only misattribute one sample to a neighboring stage,
    which the sampling error already dominates."""

    __slots__ = ("stage",)

    def __init__(self) -> None:
        self.stage = ""


STAGE_MARK = _StageMark()
