"""CUDA graph captures made inside the window. Set-up captures every
signature the window meets, so this reads 0; each capture is a stall of a
frame."""


def read(ctx):
    return float(ctx.window.captures)
