"""The features as they are."""


def form(frame, binsize):
    return frame
