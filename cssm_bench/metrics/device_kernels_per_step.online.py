"""Kernels the card ran in the traced window, per filter step."""


def read(run):
    steps = sum(1 for u in run.units if u["traced"]) \
        * run.driver.steps_per_unit(run)
    if run.trace is None or not run.trace.device or not steps:
        return None
    return len(run.trace.kernels()) / steps
