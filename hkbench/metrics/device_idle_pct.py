"""The share of the traced window, from the first call's start to the last
call's end, in which no device operation runs, in %."""


def read(summary):
    if summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (summary.window_s - summary.busy_s) / summary.window_s
