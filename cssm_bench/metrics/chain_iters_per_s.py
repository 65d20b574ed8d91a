"""Chains times MH iterations of every call completed in the window, over
the window's whole time (the first call issued to the last call done)."""


def read(run):
    work = run.driver.work(run).get("chain_iters")
    units = run.untraced()
    if work is None or not units:
        return None
    return work * len(units) / run.window_s(units)
