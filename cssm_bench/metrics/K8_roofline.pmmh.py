"""K8's share of its roofline: every chain's whole filter in one launch
(``sweep_kernel``).  Its float32 operations bound it: B chains x T steps x
N particles x ``(16 d + f + 8)`` (propagate 4 d, linear predictor 2 d, one
normal per state counted as 10, the family's density f as its reference
file states it, weighing and resampling 8).  Its bytes, the initial clouds, every step's coefficients
and constants read once and the lls and final clouds written once, bound
it less.  Over K8's mean device time a launch in the traced window."""

from cssm_bench import roofline

KERNEL = "sweep_kernel"


def least_launch_s(run) -> float:
    tr, comps = run.traffic, run.config["components"]
    b, n, t = (int(tr[k]) for k in ("n_chains", "n_particles", "n_obs"))
    d = sum(int(c["dim"]) for c in comps)
    flops = b * t * n * (16 * d + roofline.density_flops(run.config) + 8)
    values = 2 * b * d * n + t * b * (3 * d + 4) + t * d + b
    return roofline.least_seconds(values * roofline.F32, flops, run.kind)


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels(KERNEL)
    if not launches:
        return None
    return roofline.share_pct(
        least_launch_s(run), run.trace.device_seconds(KERNEL) / len(launches))
