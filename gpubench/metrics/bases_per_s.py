"""Input bases of every pile yielded in the window (raw read bases for
correct, draft contig bases for polish) over the window's seconds."""


def read(m):
    return m["bases"] / m["window_s"]
