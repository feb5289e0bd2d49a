"""Device: the share of the traced slice's wall time in which no
operation ran on the card (1 − the union of device intervals over the
slice's seconds), in %."""


def read(run):
    if run.slice is None or not run.slice["seconds"] or \
            not run.slice["busy_s"]:
        return None
    return 100.0 * (1.0 - run.slice["busy_s"] / run.slice["seconds"])
