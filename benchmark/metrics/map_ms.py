"""Mean host milliseconds of the ``map`` section of ``NiceSLAM.step`` (its
``StepTimer``) per mapping event of the window; strict sync reads each
pass's losses back inside the section."""


def read(ctx):
    w = ctx.window
    if not w.map_n:
        return None
    return 1e3 * w.map_s / w.map_n
