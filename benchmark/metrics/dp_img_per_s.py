"""Global images a second that ``Trainer.fit`` trains over the cell's
cards: the global batch times the window's whole steps over rank 0's time
between a barrier of every rank at the start and one at the end."""


def read(run):
    return run["images"] / run["window_s"]
