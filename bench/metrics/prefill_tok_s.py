"""Engine loop: prompt tokens prefilled per second of prefill calls over
the window (``Engine.stats``: ``prefill_tokens`` / ``prefill_s``)."""


def read(run):
    s = run.window["stats"]
    return s["prefill_tokens"] / s["prefill_s"] if s["prefill_s"] > 0 \
        else None
