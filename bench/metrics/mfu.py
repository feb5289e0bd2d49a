"""Model step: the model FLOPs of every token the traced slice processed
(``roofline/model.py``) over the slice's seconds at the card's bf16
peak, in %."""


def read(run):
    counted = run.work("model")
    if not counted or not run.slice["seconds"]:
        return None
    return 100.0 * counted["seconds"] / run.slice["seconds"]
