"""The host stretch of a streamed observation: the card's idle time inside
the program's ``cssm.online.step`` spans (``OnlineFilter.step``, the whole
call), in ms per traced step (:func:`cssm_bench.spans.idle_s`).  The idle
time of the window outside them is the benchmark's own."""

from cssm_bench import spans


def read(run):
    return spans.per_step_ms(run, spans.idle_s, "cssm.online.step")
