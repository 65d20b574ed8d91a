"""The summaries' order statistics as the window's steps ran them: the
device time of the operations launched inside the program's
``cssm.select`` spans (``ops.selection``), in ms per traced step
(:func:`cssm_bench.spans.device_s`; None where the launches and the
device operations of the window cannot be paired)."""

from cssm_bench import spans


def read(run):
    return spans.per_step_ms(run, spans.device_s, "cssm.select")
