"""Images a second that ``Trainer.fit`` trains on one card fed from the
host (``cli train``'s default ``BatchIterator``): the images of the
window's whole steps over the time from the window's start to the end of
its last step, after a device sync."""


def read(run):
    return run["images"] / run["window_s"]
