"""Particles times steps of every filter call completed in the window,
over the window's whole time (the first call issued to the last result
read on the host)."""


def read(run):
    work = run.driver.work(run).get("particle_steps")
    units = run.untraced()
    if work is None or not units:
        return None
    return work * len(units) / run.window_s(units)
