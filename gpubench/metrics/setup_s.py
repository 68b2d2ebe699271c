"""Seconds from the process's start to the window's start: imports,
inputs, kernel builds (a checkout's first run), captures, warm-up."""


def read(m):
    return m["setup_s"]
