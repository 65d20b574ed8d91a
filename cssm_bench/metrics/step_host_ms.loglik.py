"""The filter step's own host time: the host's time inside the program's
``cssm.filter.step`` spans (one a step of the filter's loop), less the
time it waited on a full launch queue, in ms per traced step
(:func:`cssm_bench.spans.host_s`).  Where it nears the device time of a
step, the host sets the pace."""

from cssm_bench import spans


def read(run):
    return spans.per_step_ms(run, spans.host_s, "cssm.filter.step")
