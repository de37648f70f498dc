"""The card's peak allocated memory over the window, in GB."""


def read(view):
    return view.peak_bytes / 1e9 if view.peak_bytes else None
