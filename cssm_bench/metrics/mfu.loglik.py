"""The whole filter step's least time on the card over its measured time.

One step of the log-likelihood filter at N particles and d states must
read the propagated cloud ``[d, N]`` and its log-weights ``[N]`` once and
write the resampled, propagated cloud and its new log-weights once:
``2 (d + 1) N`` float32 values, whatever kernels do it.  Its float32
operations, ``(16 d + f + 8) N`` (propagate 4 d, linear predictor 2 d, one
normal per state counted as 10, the family's density f, weighing and
resampling 8), bound it far less.  The measured time of a step is the
traced window over the steps traced."""

from cssm_bench import roofline


def least_step_s(run) -> float:
    n = int(run.traffic["n_particles"])
    d = sum(int(c["dim"]) for c in run.config["components"])
    return roofline.least_seconds(2 * (d + 1) * n * roofline.F32,
                                  (16 * d + roofline.density_flops(run.config)
                                   + 8) * n, run.kind)


def read(run):
    steps = sum(1 for u in run.units if u["traced"]) \
        * run.driver.steps_per_unit(run)
    if run.trace is None or not run.trace.device or not steps:
        return None
    return roofline.share_pct(least_step_s(run), run.trace.window_s / steps)
