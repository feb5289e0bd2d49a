"""Block pool: the share of the prompt tokens admitted in the window that
the prefix cache served (``prefix_hit_tokens`` over those plus the
tokens prefilled)."""


def read(run):
    s = run.window["stats"]
    total = s["prefix_hit_tokens"] + s["prefill_tokens"]
    return 100.0 * s["prefix_hit_tokens"] / total if total else None
