"""K2's share of its roofline: the resample + propagate + weigh stage of a
step (``resample_propagate_kernel``).  It must read the cloud ``[d, N]``
and the resampling counts ``[N]`` (int32) once and write the new cloud and
its log-weights ``[N]`` once, ``2 (d + 1) N`` 4-byte values; its float32
operations, ``(16 d + f) N`` (as ``mfu.loglik`` counts them, without the
weighing), bound it less.  Over K2's mean device time
a launch in the traced window."""

from cssm_bench import roofline

KERNEL = "resample_propagate_kernel"


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels(KERNEL)
    if not launches:
        return None
    n = int(run.traffic["n_particles"])
    d = sum(int(c["dim"]) for c in run.config["components"])
    least = roofline.least_seconds(2 * (d + 1) * n * roofline.F32,
                                   (16 * d + roofline.density_flops(run.config))
                                   * n, run.kind)
    return roofline.share_pct(
        least, run.trace.device_seconds(KERNEL) / len(launches))
