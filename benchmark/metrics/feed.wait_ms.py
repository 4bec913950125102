"""Host milliseconds a step that ``fit`` waits inside the host feed's
``__next__``, the mean over the window's steps."""


def read(run):
    spans = run["spans"].get("feed.next")
    return sum(spans) / len(spans) * 1e3 if spans else None
