"""Host milliseconds of the serving callable a chunk (upload, the int8
forward and the copy back queued, no sync), the mean over the window."""


def read(run):
    spans = run["spans"].get("serve.infer")
    return sum(spans) / len(spans) * 1e3 if spans else None
