"""The share of the traced window in which no kernel, copy or set ran on
the card."""


def read(view):
    if not view.busy_s or view.window_s <= 0:   # no operation on a card
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
