"""Points of every MSM call completed in the window, over the window's seconds
(host clock; the window spans --seconds and more)."""


def read(window):
    return window.items / window.seconds if window.seconds > 0 else None
