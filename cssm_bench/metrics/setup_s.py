"""From the start of the benchmark's module to the first timed unit:
imports, the card's start, building the kernels (in the first run of a
checkout), the series and the model, and the warm-up."""


def read(run):
    return run.setup_s
