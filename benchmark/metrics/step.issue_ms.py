"""Host milliseconds to queue one train step (``Trainer.train_step``: the
upload, the sampler, forward, backward and update issued, no sync), the
mean over the window's steps (rank 0's)."""


def read(run):
    spans = run["spans"].get("step.issue")
    return sum(spans) / len(spans) * 1e3 if spans else None
