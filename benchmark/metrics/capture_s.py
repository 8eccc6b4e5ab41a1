"""Seconds of every CUDA graph capture made before the window (the
system's ``Programs.captures`` and the process-wide ``shared_programs``),
warm-up call included: part of ``setup_s``."""


def read(ctx):
    return ctx.window.capture_s
