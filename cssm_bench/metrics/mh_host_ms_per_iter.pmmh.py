"""The MH loop's own host time: the host's time inside the program's
``cssm.pmmh.iter`` spans (one an iteration of ``_mh_scan``), less the
time it waited on a full launch queue, in ms per traced iteration
(:func:`cssm_bench.spans.host_s`).  Where it nears the device time of an
iteration, the host sets the pace."""

from cssm_bench import spans


def read(run):
    return spans.per_step_ms(run, spans.host_s, "cssm.pmmh.iter")
