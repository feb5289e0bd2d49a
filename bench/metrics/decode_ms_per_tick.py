"""Decode window: host milliseconds of decode windows per tick over the
window (``Engine.stats["decode_s"]`` over the ticks the engine ran)."""


def read(run):
    ticks = run.window["ticks"]
    return 1e3 * run.window["stats"]["decode_s"] / ticks if ticks else None
