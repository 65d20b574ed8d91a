"""The program's host reads per traced step: its ``cssm.host_read`` spans
(each read of the device that the host waits on, the time a chunk starts
at and the chunk's mask among them) over the traced steps.  None where the
program opens no ``cssm.online.step`` span."""

from cssm_bench import spans


def read(run):
    steps = spans.traced_steps(run)
    if not spans.spans(run.trace, "cssm.online.step") or not steps:
        return None
    return len(spans.spans(run.trace, "cssm.host_read")) / steps
